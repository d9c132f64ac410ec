"""repro_torch.sketch — the TensorSketch estimator family (port of
``repro.sketch``), registered as ``"tensor_sketch"`` in
``repro_torch.core.registry``."""
from repro_torch.sketch.feature_map import (
    SketchFeatureMap,
    make_sketch_feature_map,
)
from repro_torch.sketch.plan import (
    SketchPlan,
    apply_sketch_plan,
    init_sketch_params,
    make_sketch_plan,
    pack_sketch,
)
from repro_torch.sketch.ref import (
    count_sketch_ref,
    tensor_sketch_blocks_ref,
    tensor_sketch_fused_ref,
)

__all__ = [
    "SketchFeatureMap",
    "make_sketch_feature_map",
    "SketchPlan",
    "apply_sketch_plan",
    "init_sketch_params",
    "make_sketch_plan",
    "pack_sketch",
    "count_sketch_ref",
    "tensor_sketch_blocks_ref",
    "tensor_sketch_fused_ref",
]
