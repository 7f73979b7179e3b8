"""PyTorch/CUDA port of scalable_agent_tpu for one NVIDIA H100.

The JAX package `scalable_agent_tpu` is the reference: this package keeps
its module paths, config field names and trajectory contracts, and holds
its outputs to the reference's in `tests/test_torch_*.py`. It imports
torch and numpy only — never jax, flax, optax or anything of
`scalable_agent_tpu` (tests/test_torch_isolation.py pins that).

Ported so far: the fleet runtime (`driver.train`, `runtime/`, `envs/`,
`python -m scalable_agent_tpu_torch.experiment --mode=train`) and the
Anakin trainer (`parallel/anakin.py`, `--mode=anakin`), with the IMPALA
agent, the V-trace learner and the hand-written CUDA kernels
(`ops/vtrace_cuda.py`, `ops/conv_pool_cuda.py`, `csrc/`). ROADMAP.md
queues the rest.

Importing this package (or any module of it) touches no device and runs no
compiler: kernels are built at their first CUDA call (`ops/build.py`).
"""
