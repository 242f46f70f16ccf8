"""PyTorch/CUDA port of the TPU scheduler (`k8s_scheduler_tpu/`).

A second package beside the JAX reference: it imports torch and never
jax, and nothing of `k8s_scheduler_tpu`. Its layout mirrors the
reference (`models/`, `ops/`, `framework/`, `core/`, `utils/`). Entry
points take an explicit `device`; left as None they run on the card and
raise when there is none. Hand-written Hopper kernels live under
`csrc/` (CUDA C++) and in `ops/claim_pass.py` (Triton); each has a
plain-torch version beside it that the CPU path uses.
"""
