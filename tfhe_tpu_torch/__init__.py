"""tfhe_tpu_torch: the PyTorch / CUDA port of tfhe_tpu for NVIDIA Hopper.

The package mirrors `tfhe_tpu` module by module (`torus`, `rng`,
`params`, `noise`, `core/*`, `ops/*`, `models/shortint`,
`models/integer`, `models/boolean`, `models/glwe_matmul`, `ml/common`,
`ml/quantization`, `ml/linear`, `parallel/dispatch`) and imports neither
JAX nor `tfhe_tpu`. Torus values are int64 tensors carrying u64 bit patterns
(see `_u64`). Entry points take `device=` and default to "cuda"; on a
CUDA tensor every kernel wrapper launches its hand-written kernel
(`csrc/*.cu`, built by `_build`) or raises, and on a CPU tensor it runs
the kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
