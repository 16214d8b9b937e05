#!/usr/bin/env python3
"""Rehearse chip_smoke.py's phase `operator` on the CPU at a small size.

    python3 hack/rehearse_operator_phase.py [N_PODS]      (default 3000)

Runs `chip_smoke.phase_operator` with DEVICE = "cpu": the binary with
`--device cpu` (and its refusal without a card), the operator world at
N_PODS pods and a wave of N_PODS / 5 (g_max 256) and the golden corpus
through the port's replay; then `chip_smoke.phase_references` holds the
world against its device="cpu" twin in a second process. The
kernel wrappers run their plain versions on CPU tensors, so each is
wrapped to count its calls as the phase counts launches on the card.
Prints the phases' JSON lines, the launches and the seconds it took.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from karpenter_tpu_torch import metrics  # noqa: E402
from karpenter_tpu_torch.solver.kernels import disrupt_repack as kb  # noqa: E402
from karpenter_tpu_torch.solver.kernels import ffd_scan as ka  # noqa: E402


def counted(mod, name):
    fn = getattr(mod, name)

    def call(*a, **k):
        mod.launches += 1
        return fn(*a, **k)

    setattr(mod, name, call)


def main() -> int:
    torch.set_num_threads(4)
    chip_smoke.DEVICE = "cpu"
    chip_smoke.N_PODS = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    chip_smoke.N_WAVE = chip_smoke.N_PODS // 5
    chip_smoke.G_MAX = 256
    counted(ka, "fused_scan")
    counted(kb, "disrupt_repack")
    t0 = time.time()
    tag = {"card": "cpu rehearsal", "power_limit": "n/a"}
    launches, _, digests = chip_smoke.phase_operator(torch.device("cpu"), tag, metrics, ka, kb)
    references = chip_smoke.start_references({"operator": digests})
    try:
        chip_smoke.phase_references(tag, references)
    finally:
        chip_smoke.stop_references(references)
    print("launches", launches)
    print("seconds", time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
