"""The rule families. Each module exposes ``check(modules) -> [Violation]``.

Rule ids are ``family/rule`` (e.g. ``determinism/uuid4``); the family is
what ``--rules`` selects and the full id is what a baseline entry names.
"""
