"""SketchFeatureMap — a materialized TensorSketch feature map (port of
``repro.sketch.feature_map``).

A thin named carrier of ``(plan, params)`` on the shared
``core.feature_map.EstimatorFeatureMap``: ``apply`` / ``__call__`` /
``estimate_gram`` / ``output_dim`` / ``truncation_bias`` as on
``RMFeatureMap``, featurizing through the ``"tensor_sketch"`` registry entry
(kernel B6 for a CUDA tensor, its plain version for a CPU tensor), so
``train_featurized_linear`` and every other consumer takes any family.
"""
from __future__ import annotations

import torch

from repro_torch.core.feature_map import (
    EstimatorFeatureMap,
    make_estimator_map,
)
from repro_torch.core.maclaurin import DotProductKernel

__all__ = ["SketchFeatureMap", "make_sketch_feature_map"]


class SketchFeatureMap(EstimatorFeatureMap):
    """(plan, count-sketch hash tables): params
    ``{"h": int32 [num_funcs, d], "s": [num_funcs, d]}``."""

    estimator = "tensor_sketch"


def make_sketch_feature_map(
    kernel: DotProductKernel,
    input_dim: int,
    num_features: int,
    key: torch.Generator,
    *,
    p: float = 2.0,
    measure: str = "geometric",
    h01: bool = False,
    n_max: int = 24,
    radius: float = 1.0,
    omega_dtype=torch.float32,
    stratified: bool = True,
    seed: int = 0,
    device="cuda",
) -> SketchFeatureMap:
    """Build a ``SketchFeatureMap`` from ``make_feature_map``'s arguments
    (``key`` a ``torch.Generator``): the draws land on ``device``, the card
    unless the caller asks for the CPU."""
    return make_estimator_map(
        SketchFeatureMap, kernel, input_dim, num_features, key, p=p,
        measure=measure, h01=h01, n_max=n_max, radius=radius,
        omega_dtype=omega_dtype, stratified=stratified, seed=seed,
        device=device)
