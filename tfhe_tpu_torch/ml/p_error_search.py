"""Binary search of the PBS failure probability meeting an accuracy target
(counterpart of tfhe_tpu/ml/p_error_search.py; host code).

Analog of the reference's p_error search (reference:
ml/concrete-ml/src/concrete/ml/search_parameters/p_error_search.py: binary
search p_error, evaluate the model under simulation at each step, keep the
largest p_error whose accuracy stays within tolerance of the reference).
Larger tolerated p_error buys smaller/faster crypto parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from tfhe_tpu_torch import params as tp
from tfhe_tpu_torch.ml.common import FheMode
from tfhe_tpu_torch.ml.quantized_module import QuantizedTLU
from tfhe_tpu_torch.noise import failure_probability


@dataclasses.dataclass
class PErrorSearchResult:
    p_error: float
    accuracy: float
    history: list


def binary_search_p_error(
    eval_fn: Callable[[float], float],
    target_accuracy: float,
    tolerance: float = 0.01,
    lo: float = 2.0**-40,
    hi: float = 0.5,
    max_iters: int = 20,
) -> PErrorSearchResult:
    """Find the largest p_error whose accuracy >= target - tolerance.

    eval_fn(p_error) -> accuracy, typically running the model in SIMULATE
    mode with noise scaled to that failure probability.
    """
    history = []
    best = (lo, eval_fn(lo))
    history.append(best)
    if best[1] < target_accuracy - tolerance:
        return PErrorSearchResult(p_error=lo, accuracy=best[1], history=history)
    llo, lhi = math.log2(lo), math.log2(hi)
    for _ in range(max_iters):
        mid = 2.0 ** ((llo + lhi) / 2.0)
        acc = eval_fn(mid)
        history.append((mid, acc))
        if acc >= target_accuracy - tolerance:
            best = (mid, acc)
            llo = math.log2(mid)
        else:
            lhi = math.log2(mid)
        if lhi - llo < 0.1:
            break
    return PErrorSearchResult(p_error=best[0], accuracy=best[1], history=history)


def search_p_error_for_module(
    module,
    x_val,
    y_val,
    target_accuracy: float | None = None,
    tolerance: float = 0.01,
    **kw,
):
    """Bind the binary search to a QuantizedModule's SIMULATE evaluation
    (the reference's p_error_search.py loop: each probe sets every
    TLU's p_error, runs simulation, scores accuracy).

    module: calibrated QuantizedModule/QuantizedGraphModule whose TLU
    ops expose `p_error`; y_val: class labels matched against the argmax
    of the module output."""
    if hasattr(module, "ops"):
        tlus = [op for op in module.ops if isinstance(op, QuantizedTLU)]
    else:
        tlus = [n.op for n in module.nodes if isinstance(n.op, QuantizedTLU)]
    y = np.asarray(y_val)

    def eval_fn(p_error: float) -> float:
        for t in tlus:
            t.p_error = p_error
        try:
            out = module.forward(x_val, FheMode.SIMULATE)
        finally:
            for t in tlus:
                t.p_error = 0.0
        pred = np.argmax(out, axis=-1) if out.ndim > 1 else (out > 0.5)
        return float((pred == y).mean())

    if target_accuracy is None:
        target_accuracy = eval_fn(2.0**-40)
    return binary_search_p_error(eval_fn, target_accuracy, tolerance=tolerance, **kw)


# -- parameter selection -------------------------------------------------------
#
# The point of the search (the reference's p_error_search.py + the
# concrete-compiler's p_error knob): a larger tolerated failure probability
# buys smaller crypto parameters. The searched p_error feeds the analytic
# noise calculus (noise.failure_probability) to pick the cheapest parameter
# set whose per-PBS failure probability fits.


def pbs_cost(p) -> float:
    """Relative per-PBS cost model: blind-rotation work is
    n * level * (k+1)^2 * N log2 N (transform-dominated)."""
    return p.lwe_dimension * p.pbs.level * (p.glwe_dimension + 1) ** 2 * p.polynomial_size * math.log2(
        p.polynomial_size
    )


def select_crypto_params(p_error: float, candidates=None, noise_level: int = 1):
    """Cheapest parameter set whose analytic PBS failure probability is
    <= the tolerated p_error. Returns (params, predicted_p_fail).

    candidates defaults to the production ladder (1_1 and 2_2 fhevm
    families -- toy sets carry no security and are never eligible).
    Raises if nothing fits (tighten the model or accept higher p_error).
    """
    if candidates is None:
        candidates = [
            tp.PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128,
            tp.PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
            tp.PARAM_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        ]
    fits = []
    for p in sorted(candidates, key=pbs_cost):
        pf = failure_probability(p, noise_level=noise_level)
        if pf <= p_error:
            fits.append((p, pf))
    if not fits:
        raise ValueError(
            f"no candidate parameter set reaches p_error <= {p_error:.3g}; "
            "the searched tolerance is tighter than the ladder provides"
        )
    return fits[0]


def search_and_select(module, x_val, y_val, candidates=None, **kw):
    """End-to-end: binary-search the tolerated p_error under SIMULATE,
    then buy the cheapest parameter set that meets it."""
    res = search_p_error_for_module(module, x_val, y_val, **kw)
    params, pf = select_crypto_params(res.p_error, candidates=candidates)
    return res, params, pf
