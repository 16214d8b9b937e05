"""Mean time (ms) a tick in the program's `group` span: the grouping pass
of schedule() (the incremental grouper, or a fresh group_pods)."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["group"])
