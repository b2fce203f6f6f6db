"""Host utilities of the port: `keccak` (handle hashing over the native C
core), `serialization` (the JAX package's wire format) and `keycache`
(the warm-start key cache).

The JAX package's `utils/xlacache` (XLA's persistent compile cache) and
`utils/pytree` (pytree registration of dataclasses for jit) have no
counterpart: PyTorch compiles nothing per shape, and the port's
dataclasses hold tensors directly. `utils/profiling` is not ported yet.
"""
