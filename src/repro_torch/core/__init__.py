"""The paper's contribution: Random Maclaurin feature maps for dot product
kernels (Kar & Karnick, AISTATS 2012), in PyTorch (port of ``repro.core``).

``repro_torch.core.registry`` holds the estimator registry ("rm",
"tensor_sketch", "ctr", "structured"); every entry shares the
Taylor-coefficient degree measure defined here. Exported under the
reference's names: Algorithm 1 (``make_feature_map``), Algorithm 2 (the
compositional map of ``core.compositional``), the bounds, the linear
models, the ``core.static_plan`` shim, the growable map of
``core.doubling`` (the feature budget as a dial: ``grow()`` appends
generations without redrawing) and the (eps, delta) budget selection of
``core.select``."""
from repro_torch.core import registry
from repro_torch.core.bounds import (
    HoeffdingConstants,
    constants_for,
    pairwise_eps,
    pointwise_failure_prob,
    required_features_for_pairs,
    required_num_features,
    uniform_failure_prob,
)
from repro_torch.core.compositional import (
    CompositionalFeatureMap,
    RademacherInnerMap,
    RFFInnerMap,
    make_compositional_feature_map,
)
from repro_torch.core.doubling import (
    GrowableFeatureMap,
    make_growable_feature_map,
)
from repro_torch.core.feature_map import (
    RMFeatureMap,
    degree_measure,
    make_feature_map,
)
from repro_torch.core.linear_models import (
    Classifier,
    train_featurized_linear,
    train_kernel_ridge,
    train_kernel_svm,
    train_linear,
)
from repro_torch.core.maclaurin import (
    DotProductKernel,
    ExponentialDotProductKernel,
    HomogeneousPolynomialKernel,
    MaclaurinKernel,
    PolynomialKernel,
    VovkInfiniteKernel,
    VovkRealKernel,
    kernel_from_name,
)
from repro_torch.core.plan import (
    FeaturePlan,
    allocate_features,
    apply_plan,
    init_omegas,
    make_feature_plan,
    pack_omegas,
    plan_output_dim,
)
from repro_torch.core.select import BudgetDecision, CostModel, select_budget
from repro_torch.core.truncated import (
    make_truncated_feature_map,
    truncation_degree,
)

__all__ = [
    "registry",
    "FeaturePlan",
    "allocate_features",
    "apply_plan",
    "init_omegas",
    "make_feature_plan",
    "pack_omegas",
    "plan_output_dim",
    "train_featurized_linear",
    "DotProductKernel",
    "ExponentialDotProductKernel",
    "HomogeneousPolynomialKernel",
    "MaclaurinKernel",
    "PolynomialKernel",
    "VovkInfiniteKernel",
    "VovkRealKernel",
    "kernel_from_name",
    "RMFeatureMap",
    "degree_measure",
    "make_feature_map",
    "CompositionalFeatureMap",
    "RademacherInnerMap",
    "RFFInnerMap",
    "make_compositional_feature_map",
    "GrowableFeatureMap",
    "make_growable_feature_map",
    "BudgetDecision",
    "CostModel",
    "select_budget",
    "make_truncated_feature_map",
    "truncation_degree",
    "HoeffdingConstants",
    "constants_for",
    "pointwise_failure_prob",
    "required_num_features",
    "pairwise_eps",
    "required_features_for_pairs",
    "uniform_failure_prob",
    "Classifier",
    "train_kernel_ridge",
    "train_kernel_svm",
    "train_linear",
]
