"""Utilities: env-var config, device selection, compile cache, operator
oracles, contour extraction."""

from totsu_tpu.utils.compile_cache import enable_compile_cache
from totsu_tpu.utils.env import set_par_by_env, use_cpu
from totsu_tpu.utils.operator_check import check_operator
from totsu_tpu.utils.contour import (
    contour_segments, contour_series, chain_segments)

__all__ = ["enable_compile_cache", "set_par_by_env", "use_cpu",
           "check_operator",
           "contour_segments", "contour_series", "chain_segments"]
