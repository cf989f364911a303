"""The single long-series requests' idle share, read as the dense serving
cell's: over the untraced wall time of as many requests, since the host
paces them and the profiler lengthens the host's part."""

from pathlib import Path

from portbench.cells import load_module

read = load_module(Path(__file__).with_name("device_idle_pct.serve.py")).read
