"""The port's estimator registry and model package expose what the
reference's do: every family's ``truncation_bias`` (the dropped-degree
kernel mass of a plan, paper section 4.2) equals the reference's on the
same plan, handed across field by field, and ``repro_torch.models``
re-exports ``loss_fn`` as ``repro.models`` does."""
import pytest

from repro.core import registry as jreg
from repro.core.maclaurin import ExponentialDotProductKernel as JExp
from repro_torch.core import registry
from repro_torch.core.maclaurin import ExponentialDotProductKernel as TExp

FAMILIES = ("rm", "tensor_sketch", "ctr", "structured")


@pytest.mark.parametrize("n_max", [4, 8, 12, 16])
@pytest.mark.parametrize("name", FAMILIES)
def test_truncation_bias_matches_reference(name, n_max):
    """Exact equality: both packages run the same host-side arithmetic on
    the same plan fields."""
    jplan = jreg.get(name).make_plan(JExp(1.0), 16, 64, n_max=n_max, seed=0)
    port_plan = registry.get(name).make_plan(TExp(1.0), 16, 64,
                                             n_max=n_max, seed=0)
    plan = type(port_plan)(*tuple(jplan))
    assert plan == port_plan
    want = jreg.get(name).truncation_bias(jplan, 1.0)
    got = registry.get(name).truncation_bias(plan, 1.0)
    assert isinstance(got, float)
    assert got == want
    assert got >= 0.0


def test_truncation_bias_is_a_field_of_every_entry():
    for name in registry.list_estimators():
        assert callable(registry.get(name).truncation_bias)


def test_models_reexport_loss_fn():
    from repro_torch.models import loss_fn
    from repro_torch.models.transformer import loss_fn as direct

    assert loss_fn is direct
