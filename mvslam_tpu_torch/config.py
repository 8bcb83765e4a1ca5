"""Numeric constants, dtype policy and runtime parameters (the subset of
``mvslam_tpu.config`` the port uses). Constants resolve from the dtype of
the data flowing through: float64 in the oracle tests, float32 on the
device. ``ParameterManager`` is the INI-style ``system.param`` store."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch

#: default compute dtype on device
DEFAULT_DTYPE = torch.float32


def epsilon(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """Smallest meaningful magnitude (machine epsilon of ``dtype``)."""
    return float(torch.finfo(dtype).eps)


def tolerance(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """General-purpose small tolerance: 1000 * epsilon."""
    return 1000.0 * epsilon(dtype)


def infinity(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """A large-but-finite sentinel: a tenth of the dtype's maximum."""
    return float(torch.finfo(dtype).max / 10.0)


def taylor_threshold(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """Angle below which Lie-group trig is Taylor-expanded (1e-5 for
    float64, scaled to 1e-3 for float32)."""
    return 1e-5 if dtype == torch.float64 else 1e-3


# ---------------------------------------------------------------------------
# Runtime parameters (copy of the JAX package's ``ParameterManager``)
# ---------------------------------------------------------------------------


def _convert(value: str, ty: type):
    """String -> typed value. bool semantics: the literal
    "TRUE"/"true" or any positive scalar is True; "FALSE"/"false" or any
    non-positive scalar is False.
    """
    value = value.strip()
    if ty is bool:
        if value.upper() == "TRUE":
            return True
        if value.upper() == "FALSE":
            return False
        try:
            return float(value) > 0
        except ValueError as e:
            raise ValueError(f"cannot convert {value!r} to bool") from e
    if ty is int:
        return int(float(value)) if ("." in value or "e" in value.lower()) else int(value)
    if ty is float:
        return float(value)
    if ty is str:
        return value
    raise TypeError(f"unsupported parameter type {ty!r}")


class ParameterManager:
    """INI-style runtime parameter store.

    File format: ``[module]`` section headers, one ``key = value`` per
    line, blank lines ignored. A process-global instance lives at
    ``ParameterManager.global_instance()``; module defaults flow through
    :meth:`get_value`.
    """

    _global: "ParameterManager | None" = None

    def __init__(self) -> None:
        self._params: Dict[str, Dict[str, str]] = {}

    # -- global singleton access ---------------------------------------------
    @classmethod
    def global_instance(cls) -> "ParameterManager":
        if cls._global is None:
            cls._global = ParameterManager()
        return cls._global

    # -- IO -----------------------------------------------------------------
    def load_from_file(self, filename: str) -> int:
        """Load parameters; returns the number of variables loaded."""
        self._params.clear()
        module = None
        count = 0
        with open(filename, "r") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#") or line.startswith(";"):
                    continue
                if len(line) > 2 and line[0] == "[" and line[-1] == "]":
                    module = line[1:-1].strip()
                    if not module:
                        raise ValueError("empty module name")
                    if module in self._params:
                        raise ValueError(f"duplicated module {module!r}")
                    self._params[module] = {}
                elif line.count("=") == 1:
                    if module is None:
                        raise ValueError(f"variable before any [module]: {raw!r}")
                    key, value = (s.strip() for s in line.split("="))
                    if not key:
                        raise ValueError(f"empty variable name in module {module!r}")
                    if key in self._params[module]:
                        raise ValueError(f"duplicate variable {key!r} in {module!r}")
                    self._params[module][key] = value
                    count += 1
                else:
                    raise ValueError(f"invalid line: {raw!r}")
        # drop empty modules
        self._params = {m: kv for m, kv in self._params.items() if kv}
        return count

    def save_to_file(self, filename: str) -> int:
        count = 0
        with open(filename, "w") as f:
            for module, kv in self._params.items():
                f.write(f"[{module}]\n")
                for key, value in kv.items():
                    f.write(f"{key} = {value}\n")
                    count += 1
                f.write("\n")
        return count

    # -- typed access ---------------------------------------------------------
    def get_value(self, module: str, key: str, default: Any):
        """Typed lookup with default (type inferred from the default)."""
        try:
            raw = self._params[module][key]
        except KeyError:
            return default
        return _convert(raw, type(default))

    def set_value(self, module: str, key: str, value: Any) -> None:
        self._params.setdefault(module, {})[key] = str(value)

    def clear(self) -> None:
        self._params.clear()

    def module_count(self) -> int:
        return len(self._params)

    def variable_count(self) -> int:
        return sum(len(kv) for kv in self._params.values())

    # test backdoor
    def DEBUG_set_module_parameters(
        self, module: str, variables: Mapping[str, str]
    ) -> bool:
        overwritten = module in self._params
        self._params[module] = dict(variables)
        return overwritten


# module-level conveniences over the global instance
def load_from_file(filename: str) -> int:
    return ParameterManager.global_instance().load_from_file(filename)


def save_to_file(filename: str) -> int:
    return ParameterManager.global_instance().save_to_file(filename)


def get_value(module: str, key: str, default: Any):
    return ParameterManager.global_instance().get_value(module, key, default)


@dataclasses.dataclass(frozen=True)
class StaticShapes:
    """Static shape budget of the pipeline: every per-frame quantity is
    padded to these capacities and masked."""

    max_features: int = 512          # ORB features per frame
    max_matches: int = 512           # one candidate match per query feature
    max_tracked_points: int = 1024   # capacity of the VO map pool
    ransac_hypotheses: int = 256     # batched RANSAC (essential and PnP)
    pyramid_levels: int = 8          # ORB pyramid depth


DEFAULT_SHAPES = StaticShapes()
