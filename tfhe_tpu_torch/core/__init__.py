"""Ciphertext and key layer: keys, LWE, GLWE, GGSW, bootstrap, packing
keyswitch, seeded and compressed GLWE. Re-exports the JAX package's 22
`tfhe_tpu.core` names."""

from tfhe_tpu_torch.core.keys import (
    GlweSecretKey,
    LweSecretKey,
    gen_glwe_secret_key,
    gen_lwe_secret_key,
    glwe_to_lwe_secret_key,
)
from tfhe_tpu_torch.core.glwe import (
    decrypt_glwe,
    encrypt_glwe,
    trivial_glwe,
)
from tfhe_tpu_torch.core.lwe import (
    KeyswitchKey,
    decrypt_lwe,
    encrypt_lwe,
    gen_keyswitch_key,
    keyswitch,
    sample_extract,
    trivial_lwe,
)
from tfhe_tpu_torch.core.ggsw import (
    cmux,
    encrypt_ggsw_bits,
    external_product,
)
from tfhe_tpu_torch.core.bootstrap import (
    BootstrapKey,
    blind_rotate,
    gen_bootstrap_key,
    programmable_bootstrap,
)
