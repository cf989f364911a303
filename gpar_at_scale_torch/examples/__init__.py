"""The example drivers on the port, one module per script of ``examples/``.

Each runs as ``python -m gpar_at_scale_torch.examples.<name> [--cpu]``: on
the card unless ``--cpu`` is given (without a card and without ``--cpu`` it
raises, ``device.py::resolve_device``).  Importing a module runs nothing;
its functions return what its script prints, for tests and
``chip_smoke.py``.  Plots go to ``gpar_at_scale_torch/examples/out/`` when
matplotlib is present.
"""
