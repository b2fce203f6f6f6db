"""The fhevm API surface of the port (counterpart of tfhe_tpu/api):
`create_instance` / `FhevmInstance`, compact-PKE inputs with ZK proofs,
the HTTP coprocessor server `serve.FheServer` and its client, the ACL,
handles, attestation, KMS and ML-KEM. The host-only modules are copies
of the JAX package's; the device modules (`instance`, `compact_pke`,
`public_key`, `threshold`) run on `device=`, default "cuda"."""

from tfhe_tpu_torch.api.types import FheType, FHE_TYPES, type_from_bits
from tfhe_tpu_torch.api.handles import FhevmHandle
from tfhe_tpu_torch.api.instance import FhevmInstance, create_instance
