"""The benchmark of the PyTorch and CUDA port (``gpar_at_scale_torch``) on
one H100: ``python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  It imports neither JAX nor the JAX
package."""
