"""Count the tensor operations of the port's LM solve, and the LM iterations
of a pair's solves, on the CPU.

    python3 tools/count_lm_ops.py [--rows 4096] [--k 20] [--pair bunny35k]

Each operation the LM step dispatches (views aside) is one kernel on a CUDA
device, launched by the host when the step runs eagerly and replayed as a
node of a CUDA graph when it does not. It prints one JSON line: the
operations of ``lm_init`` (the initial E-step), of one ``lm_step``, of the
7x7 solve inside it, and with ``--pair`` the LM iterations of each outer
iteration's solve on that fixture pair (tests/data/torch_port_<pair>_ref.json,
the grid engine, on the CPU; a few seconds for bunny35k, minutes for
kitti131k). Counts, not times: a time comes only from a run on the card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = Path(__file__).resolve().parent.parent
# Operations that make a view or a host scalar and launch nothing.
_NO_KERNEL = {"view", "_unsafe_view", "alias", "t", "transpose", "permute", "expand",
              "slice", "select", "unsqueeze", "squeeze", "as_strided", "detach",
              "lift_fresh", "diagonal", "unbind", "split", "reshape", "scalar_tensor"}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in _NO_KERNEL:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def _count(fn) -> int:
    with _Count() as c:
        fn()
    return sum(c.ops.values())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--pair", choices=("bunny35k", "kitti131k"))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from probabilistic_point_clouds_registration_tpu_torch.models import em_lm

    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.normal(size=(args.rows, 3)).astype(np.float32))
    tgt = src[:, None, :] + torch.as_tensor(
        rng.normal(scale=0.05, size=(args.rows, args.k, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.random((args.rows, args.k)) > 0.2)
    q0, t0 = torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3)
    config = em_lm.LMConfig(max_iterations=50)
    state, _ = em_lm.lm_init(src, tgt, mask, q0, t0, config)
    a = torch.eye(7) + 0.1 * torch.as_tensor(rng.normal(size=(7, 7)).astype(np.float32))
    out = {
        "rows": args.rows, "k": args.k,
        "ops_lm_init": _count(lambda: em_lm.lm_init(src, tgt, mask, q0, t0, config)),
        "ops_lm_step": _count(lambda: em_lm.lm_step(state, src, tgt, mask, config)),
        "ops_solve_7x7": _count(lambda: em_lm._solve_lu(a, torch.ones(7))),
    }
    if args.pair:
        sys.path.insert(0, str(REPO / "tests"))
        import torch_port_fixture

        import probabilistic_point_clouds_registration_tpu_torch as port
        from probabilistic_point_clouds_registration_tpu_torch.io import synthetic

        spec = torch_port_fixture.PAIRS[args.pair]
        src_np, tgt_np = torch_port_fixture.make_pair(spec["pair"], synthetic)
        reg = port.ProbabilisticRegistration(
            src_np, tgt_np, port.RegistrationParams(**spec["params"], search_impl="grid"),
            device="cpu")
        reg.align()
        out["pair"] = args.pair
        out["lm_iterations_per_solve"] = reg.inner_iterations
    print(json.dumps(out))


if __name__ == "__main__":
    main()
