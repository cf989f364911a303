"""What the timing tools under tools/ share: running one checkout per process
in turns (``run_trees``), building variants of a CUDA source with nvcc
(``patch_source``, ``build_variants``), timing a call with CUDA events
(``event_ms``), reading the card's clocks (``print_clocks``) and loading
this checkout's ``chip_smoke.py`` as the measuring code
(``this_chip_smoke``).  Nothing here runs on import; the CUDA parts need a
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# A kernel that spins for a given number of SM cycles, appended to a variant's
# source so that the SM clock can be read beside nvidia-smi's.
SPIN = r'''
__global__ void spin_kernel(long long cycles, long long* out) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
  if (threadIdx.x == 0) out[0] = clock64() - t0;
}
extern "C" int spin(long long cycles, void* out, void* stream) {
  spin_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(cycles, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''


def _smi(fields: str) -> str:
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    return smi.stdout.strip() or "nvidia-smi: no output"


def this_chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path: the timing tools
    measure every tree with the same code."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_trees(script: str, time_tree, default_reps: int, description: str, argv=None) -> int:
    """The command line of a tool that times checkouts in turns.

    Each ``--root`` (default: this checkout) is timed in its own process,
    which runs ``script`` again with ``--one ROOT``: that checkout's root is
    put first on sys.path, and ``time_tree(root, reps, seed)`` is called
    there and its dict printed as one JSON line.  The card's name and power
    limit are printed first."""
    tool = Path(script).stem
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--root", action="append", default=None, help="a checkout (repeatable)")
    ap.add_argument("--reps", type=int, default=default_reps)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.one is not None:  # the child process of one tree
        root = Path(args.one).resolve()
        sys.path.insert(0, str(root))
        import torch

        if not torch.cuda.is_available():
            print(f"{tool}: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps({"root": str(root), "numbers": time_tree(root, args.reps, args.seed)}),
              flush=True)
        return 0

    print(_smi("name,power.limit"), flush=True)
    rc = 0
    for root in args.root or [str(ROOT)]:
        proc = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--one", root,
             "--reps", str(args.reps), "--seed", str(args.seed)],
            env=dict(os.environ, PYTHONPATH=str(Path(root).resolve())), check=False,
        )
        rc = rc or proc.returncode
    return rc


def patch_source(tool: str, edits, name: str = "dense", root: Path = ROOT) -> str:
    """csrc/<name>.cu of the checkout ``root`` with each (old, new) of
    ``edits`` applied, in order; each ``old`` must occur exactly once, so a
    tool whose markers went stale stops."""
    s = (Path(root) / "gpar_at_scale_torch" / "csrc" / f"{name}.cu").read_text()
    for old, new in edits:
        if s.count(old) != 1:
            raise SystemExit(f"{tool}: csrc/{name}.cu no longer has the marker {old!r}")
        s = s.replace(old, new)
    return s


def build_variants(tool: str, source: str, variants: dict, entries: dict, name: str = "dense",
                   root: Path = ROOT) -> dict:
    """Build ``source`` (a variant of csrc/<name>.cu of ``root``, whose
    headers it includes) plus the spin kernel once per variant (name -> extra
    nvcc flags), all nvcc processes at once, under build/<tool>/; returns
    name -> CDLL with ``entries`` (symbol -> ctypes argtypes) bound, each
    returning an int."""
    from gpar_at_scale_torch.ops.build import NVCC_FLAGS, _nvcc

    out_dir = ROOT / "build" / tool
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}_variant.cu"
    src.write_text(source + SPIN)
    csrc = Path(root).resolve() / "gpar_at_scale_torch" / "csrc"
    flags = [f for f in NVCC_FLAGS if f != "-Xptxas=-v"] + ["-I", str(csrc)]
    # a left-out step leaves variables unused: nvcc's warnings are expected
    procs = {v: (subprocess.Popen([_nvcc(), *flags, *defs, "-o", str(out_dir / f"{name}{i}.so"),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True), out_dir / f"{name}{i}.so")
             for i, (v, defs) in enumerate(variants.items())}
    libs = {}
    for v, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tool}: nvcc failed for {v}:\n{log}")
        libs[v] = ctypes.CDLL(str(so))
        for sym, argtypes in {**entries, "spin": [ctypes.c_longlong, ctypes.c_void_p,
                                                  ctypes.c_void_p]}.items():
            fn = getattr(libs[v], sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return libs


def event_ms(call, reps: int) -> float:
    """Milliseconds per call of call(), by CUDA events over ``reps`` calls
    after three warm-up calls."""
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def print_clocks(lib) -> None:
    """nvidia-smi's name, power limit and SM clocks, and the SM clock measured
    by ``lib``'s spin kernel, so a slow step is not mistaken for a slow clock."""
    import torch

    print(_smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.zeros(1, dtype=torch.int64, device="cuda")
    for cycles in (10**6, 10**7):  # the first warms the card up
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        lib.spin(cycles, out.data_ptr(), stream)
        e1.record()
        torch.cuda.synchronize()
    print(f"SM clock from a spinning kernel: {cycles / e0.elapsed_time(e1) / 1e3:.0f} MHz", flush=True)
