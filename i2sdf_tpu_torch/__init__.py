"""PyTorch/CUDA port of `i2sdf_tpu` for one NVIDIA H100.

The JAX package `i2sdf_tpu` is the reference; this package imports none of
it, and none of JAX. It keeps the reference's module names where that helps
a reader find the counterpart (`config/`, `utils/cameras.py`,
`models/mlp.py`, `models/sampler.py`, `ops/kernels/...`).

Slice 1 is the eval render of the flagship config (`configs/synthetic.yml`,
`python -m i2sdf_tpu_torch.main --conf configs/synthetic.yml --test
--test_mode render`). Slice 2 is its training step
(`python -m i2sdf_tpu_torch.main --conf configs/synthetic_quality.yml
--scan_id 1 --max_steps N [--resume]`). Their hot functions are four
hand-written CUDA kernels (`csrc/*.cu`, listed in `ops/kernels/`); each
has a plain PyTorch version beside it that the CPU path and the tests use.
"""
