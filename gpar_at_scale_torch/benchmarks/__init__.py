"""The benchmark drivers on the port: ``bench.py`` (the repo's headline
``bench.py``) and one module per script of ``benchmarks/`` ported so far.

Each runs as ``python -m gpar_at_scale_torch.benchmarks.<name> [--cpu]``,
on the card unless ``--cpu`` is given; importing one runs nothing.
"""
