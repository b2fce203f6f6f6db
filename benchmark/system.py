"""What the benchmark takes from the system under test, `tfhe_tpu_torch`:
its parameter set type and its program counters. Imported only after the
harness has set the environment the configuration asks for."""

from __future__ import annotations

import importlib


def program_params(cfg: dict):
    """The program's ShortintParams built from a configuration file's
    numbers. The program reads a multi-bit group size from the set's name,
    which has to give the file's `grouping_factor`."""
    from tfhe_tpu_torch import params as tp
    from tfhe_tpu_torch.models import shortint as si

    def noise(b):
        return tp.NoiseDistribution.zero() if b is None else tp.NoiseDistribution.tuniform(b)

    p = tp.ShortintParams(
        name=cfg["parameter_set"],
        lwe_dimension=cfg["lwe_dimension"],
        glwe_dimension=cfg["glwe_dimension"],
        polynomial_size=cfg["polynomial_size"],
        lwe_noise=noise(cfg["lwe_noise_log2"]),
        glwe_noise=noise(cfg["glwe_noise_log2"]),
        pbs=tp.GadgetParams(base_log=cfg["pbs_base_log"], level=cfg["pbs_level"]),
        ks=tp.GadgetParams(base_log=cfg["ks_base_log"], level=cfg["ks_level"]),
        message_modulus=cfg["message_modulus"],
        carry_modulus=cfg["carry_modulus"],
    )
    if si.multibit_group_of(p) != cfg.get("grouping_factor"):
        raise ValueError(f"{cfg['name']}: the program reads another group size from {p.name}")
    return p


def read_counter(path: str) -> float:
    """A program counter named "module:attr.attr". A counter that a metric
    reader names and the program lacks refuses the run: a renamed counter
    must not silently drop the metrics that read it."""
    from benchmark.harness import Refused

    mod, _, attrs = path.partition(":")
    try:
        obj = importlib.import_module(mod)
        for a in attrs.split("."):
            obj = getattr(obj, a)
    except (ImportError, AttributeError) as e:
        raise Refused(f"the program has no counter {path}: {e}") from e
    return float(obj)
