"""PyTorch + CUDA port of the GPAR inference engine.

Mirrors the subpackage layout and function names of ``gpar_at_scale_tpu``
(the JAX reference) so each counterpart is easy to find.  The port imports
neither JAX nor the JAX package.
"""

from gpar_at_scale_torch import device  # noqa: F401  (sets the precision policy)
