"""Peak device memory and seconds of the associative-scan engine under
autograd, at the chain's widths and several series lengths.

    python3 tools/assoc_memory.py [--n 100000 1000000] [--seed 0]

For each N it runs ``chip_smoke.py``'s two autograd cases of the engine on
the first N steps of the seeded chain (P = 3, M = 32, float32): one
objective and gradient of the sum-kernel conditional (Matern-5/2 +
Matern-1/2, d = 4) under ``filter_impl="pallas"``, and 3 Adam steps of the
Matern-5/2 conditional (d = 3) under ``filter_impl="associative"``.  Autograd
keeps every doubling level's elements, so memory grows as N log2 N; a run
that does not fit the card prints "out of memory", one whose factorization
fails prints the error, and the next case runs.
Needs a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.chip_timing import _smi, this_chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[100_000, 1_000_000])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("assoc_memory: no CUDA device is available", file=sys.stderr)
        return 2
    cs = this_chip_smoke()
    from gpar_at_scale_torch.data.chain import make_chain_data

    print(_smi("name,power.limit"), flush=True)
    t_np, Y_np, _, _, _ = make_chain_data(max(args.n), 10, 3, np.random.default_rng(args.seed))
    f32 = torch.float32
    t = torch.as_tensor(t_np).to("cuda", f32)
    Y = torch.as_tensor(Y_np).to("cuda", f32)
    params = [torch.as_tensor(p).to("cuda", f32) for p in cs.seeded_params(3, args.seed)]
    failures = []
    for n in args.n:
        for case in (cs.assoc_sum_conditional, cs.assoc_adam):
            torch.cuda.empty_cache()
            try:
                case(t, Y, params, n, failures)
            except torch.cuda.OutOfMemoryError:
                print(f"[assoc-memory] {case.__name__} N={n}: out of memory (peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)
            except torch.linalg.LinAlgError as e:
                print(f"[assoc-memory] {case.__name__} N={n}: {e}", flush=True)
    for f in failures:
        print(f"[assoc-memory] check: {f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
