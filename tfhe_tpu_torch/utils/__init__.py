"""Host utilities of the port: `keccak` (handle hashing over the native C
core), `serialization` (the JAX package's wire format), `keycache`
(the warm-start key cache) and `profiling` (timed sections, a
torch.profiler device trace, the PBS speed-of-light counts).

The JAX package's `utils/xlacache` (XLA's persistent compile cache) and
`utils/pytree` (pytree registration of dataclasses for jit) have no
counterpart: PyTorch compiles nothing per shape, and the port's
dataclasses hold tensors directly.
"""
