"""Analytic noise estimation for parameter validation and the ML layer's
simulation mode (a copy of tfhe_tpu/noise.py over the port's params; host
code, `math` only).

Closed-form variances for each pipeline stage, composed into a
per-parameter-set failure probability, and the GLWE matmul's output noise
profile that GlweLinearLayerExecutor's SIMULATE mode samples from.
Conventions: variances in absolute torus units (q = 2^64); binary secrets
(mean 1/2, variance 1/4).
"""

from __future__ import annotations

import math

from tfhe_tpu_torch.params import (
    BooleanParams,
    GadgetParams,
    Q_BITS,
    ShortintParams,
)

Q = 2.0**Q_BITS

def _crt_prod() -> int:
    """The folded CRT engine's modulus product over the process's prime
    set (ops/folded_ntt.default_primes()): noise terms that depend on the
    PKSK's modulus-switched storage need the max-product-bits of the
    engine that runs."""
    from tfhe_tpu_torch.ops.folded_ntt import default_primes

    return math.prod(default_primes())


def keyswitch_variance(
    n_in: int, gadget: GadgetParams, key_noise_var: float
) -> float:
    """Added variance of an LWE keyswitch with balanced base-B digits.

    Two terms: (1) decomposition rounding -- the discarded low bits act as
    uniform noise of width q/B^level per input coefficient times the
    secret; (2) digit-weighted key noise.
    """
    b, l = gadget.base_log, gadget.level
    base = 2.0**b
    # digit variance for balanced digits ~ Uniform(-B/2, B/2): B^2/12
    digit_var = (base**2) / 12.0
    key_term = n_in * l * digit_var * key_noise_var
    # rounding: dropped tail is ~ Uniform(0, q/B^l) times binary secret
    tail = Q / (base**l)
    round_term = n_in * (tail**2 / 12.0) * 0.25
    return key_term + round_term


def external_product_variance(
    k: int, n_poly: int, gadget: GadgetParams, key_noise_var: float
) -> float:
    """Added variance of one external product (GGSW x GLWE)."""
    b, l = gadget.base_log, gadget.level
    base = 2.0**b
    digit_var = (base**2) / 12.0
    key_term = (k + 1) * l * n_poly * digit_var * key_noise_var
    tail = Q / (base**l)
    round_term = k * n_poly * (tail**2 / 12.0) * 0.25
    return key_term + round_term


def blind_rotate_variance(
    n_lwe: int, k: int, n_poly: int, gadget: GadgetParams, key_noise_var: float
) -> float:
    """n CMuxes, each one external product.

    The fused CMux kernel evaluates acc += (X^a - 1) * EP(acc): the
    (X^a - 1) factor doubles the EP noise variance (two monomial copies),
    hence the factor 2, a conservative bound that also covers the loop of
    external products (whose factor is 1)."""
    return 2.0 * n_lwe * external_product_variance(
        k, n_poly, gadget, key_noise_var
    )


def mod_switch_variance(n_lwe: int, n_poly: int) -> float:
    """Rounding q -> 2N before blind rotation (scaled back to q units)."""
    step = Q / (2 * n_poly)
    return (n_lwe * 0.25 + 1.0) * (step**2) / 12.0


def pbs_output_variance(p: ShortintParams | BooleanParams) -> float:
    """Variance of a fresh PBS output (before any linear ops)."""
    return blind_rotate_variance(
        p.lwe_dimension,
        p.glwe_dimension,
        p.polynomial_size,
        p.pbs,
        p.glwe_noise.variance_torus(),
    )


def atom_input_variance(p: ShortintParams | BooleanParams, noise_level: int = 1) -> float:
    """Variance at the input of the blind rotation for the standard atom:
    fresh/PBS ct (scaled by noise_level) -> keyswitch -> mod switch."""
    v = pbs_output_variance(p) * noise_level
    v += keyswitch_variance(
        p.glwe_dimension * p.polynomial_size, p.ks, p.lwe_noise.variance_torus()
    )
    v += mod_switch_variance(p.lwe_dimension, p.polynomial_size)
    return v


def failure_probability(p: ShortintParams, noise_level: int | None = None) -> float:
    """Per-PBS decryption/rotation failure probability for the shortint
    atom: the phase must stay within half a LUT box of its code.

    noise_level defaults to the scheme's worst legal pre-PBS state
    (message+carry space fully used; tfhe-rs max_noise_level analog).
    """
    if noise_level is None:
        noise_level = p.message_modulus  # conservative: several summed cts
    var = atom_input_variance(p, noise_level)
    std = math.sqrt(var)
    # margin: half a plaintext box
    margin = Q / (2 * p.plaintext_modulus)
    return math.erfc(margin / (std * math.sqrt(2.0)))


def boolean_failure_probability(p: BooleanParams) -> float:
    """Gate failure: after the linear combination of <= 2 cts + constant,
    the phase must stay within 1/16 of the torus of its nominal point
    (gap between the +-1/8 codes and the sign boundary is 1/8; linear
    combos double input noise)."""
    v = 2.0 * atom_input_variance(p, 1)
    std = math.sqrt(v)
    margin = Q / 16.0
    return math.erfc(margin / (std * math.sqrt(2.0)))


# -- GLWE matmul noise profiles (reference C24) --------------------------------


def matmul_output_variance(
    params, inner_dim: int, w_abs_max: float = 127.0
) -> float:
    """Analytic output-LWE variance of the encrypted-clear matmul pipeline
    (encrypt -> dot -> sample extract -> packing keyswitch -> modulus
    switch), in absolute torus units.

    The reference ships empirically measured profiles per inner dim
    (noise_profiles/MANIFEST.json, keyed by params hash); this is the
    closed-form equivalent. w_abs_max bounds the clear weights (the dot
    against a clear polynomial scales encryption noise by ||w||_2 <=
    w_abs_max * sqrt(inner_dim)).
    """
    n_poly = params.polynomial_size
    k = params.glwe_dimension
    enc_var = params.glwe_noise.variance_torus()
    # dot with the clear operand: sum of inner_dim weighted noise coeffs
    dot_var = enc_var * inner_dim * (w_abs_max**2) / 3.0  # E[w^2] ~ max^2/3
    # packing keyswitch of the extracted LWE (dimension k*N)
    pks_var = keyswitch_variance(
        k * n_poly, params.packing_ks, params.packing_ks_noise.variance_torus()
    )
    # PKSK storage rounding: the packing key is modulus-switched for CRT
    # summation headroom (core/packing.py); per key coefficient the
    # rounding error is U(+-2^(shift-1)) scaled back by 2^shift, each
    # digit x error product convolves over up to N packed positions and
    # sums across n_in*level rows (worst case t = N)
    b, lvl = params.packing_ks.base_log, params.packing_ks.level
    n_in = k * n_poly
    maxpb = math.floor(math.log2(_crt_prod() / 2) - math.log2(n_poly))
    msb = min(55, maxpb - (b - 1) - math.ceil(math.log2(n_in * lvl)))
    shift = 64 - msb
    e_d2 = (2.0 ** (2 * b - 2)) / 3.0  # E[digit^2], balanced digits
    pks_round_var = (
        n_poly * n_in * lvl * e_d2 * (2.0 ** (2 * shift)) / 12.0
    )
    # storage modulus switch rounding
    tail = Q / (2.0**params.ct_modulus_out_bits)
    ms_var = (tail**2) / 12.0 * (1.0 + k * n_poly * 0.25)
    return dot_var + pks_var + pks_round_var + ms_var


def matmul_noise_profile(params, inner_dims=(2048, 4096, 8192)) -> dict:
    """Noise profile dict keyed like the reference's MANIFEST.json:
    {params_hash, profiles: {inner_dim: output_std_in_lsb}} where the
    std is expressed in units of the output quantization step
    (q / 2^bits_reserved_for_computation)."""
    delta = Q / (2.0**params.bits_reserved_for_computation)
    profiles = {}
    for d in inner_dims:
        std = math.sqrt(matmul_output_variance(params, d))
        profiles[str(d)] = std / delta
    return {"params_hash": params.hash, "profiles": profiles}


def find_noise_profile(params, inner_dim: int) -> float:
    """Output noise std (in output-quantization LSBs) for the given inner
    dimension (reference utils_simulation.py:48-70 find_noise_profile --
    nearest registered inner dim, analytic here)."""
    dims = (2048, 4096, 8192)
    nearest = min(dims, key=lambda d: abs(d - inner_dim))
    prof = matmul_noise_profile(params, (nearest,))
    return prof["profiles"][str(nearest)]
