import time

import pytest

from anemoi_models_tpu.utils import DotDict, as_dotdict, instantiate, register, resolve_target
from anemoi_models_tpu.utils.profiling import StepTimer, annotate


def test_dotdict_nested_access_and_mutation():
    d = DotDict({"a": {"b": {"c": 1}}, "lst": [{"x": 2}]})
    assert d.a.b.c == 1
    assert d.lst[0].x == 2
    d.a.b.c = 5
    assert d["a"]["b"]["c"] == 5
    d.new = {"k": 1}
    assert d.new.k == 1
    with pytest.raises(AttributeError):
        _ = d.missing


def test_dotdict_to_dict_roundtrip():
    d = DotDict({"a": {"b": 1}, "t": (1, {"c": 2})})
    plain = d.to_dict()
    assert type(plain["a"]) is dict
    assert plain["t"][1] == {"c": 2}


def test_as_dotdict_from_frozen():
    from types import MappingProxyType

    fd = MappingProxyType({"a": MappingProxyType({"b": 3})})
    d = as_dotdict(fd)
    assert d.a.b == 3


def test_register_and_resolve():
    @register("my.custom.Thing")
    def thing(x=1):
        return ("thing", x)

    assert resolve_target("my.custom.Thing") is thing
    assert instantiate({"_target_": "my.custom.Thing", "x": 5}) == ("thing", 5)


def test_instantiate_alias_rewrite():
    fn = resolve_target("anemoi.models.layers.mlp.MLP")
    from anemoi_models_tpu.layers import MLP

    assert fn is MLP


def test_step_timer():
    timer = StepTimer(items_per_step=100, warmup=1)
    for _ in range(3):
        with timer:
            time.sleep(0.01)
    assert timer.mean_step_s() >= 0.009
    assert timer.items_per_s() > 0
    assert "items/s" in timer.summary()


def test_annotate_context():
    with annotate("region"):
        pass


@pytest.mark.parametrize("name", ["no_such_package_xyz", "no_such_package_xyz.sub"])
def test_optional_import_names_what_needs_it(name):
    from anemoi_models_tpu.utils.optional import optional_import

    with pytest.raises(ImportError, match="zstd-compressed zarr chunks needs the optional package"):
        optional_import(name, "zstd-compressed zarr chunks")


def test_optional_import_returns_module():
    from anemoi_models_tpu.utils.optional import optional_import

    assert optional_import("json", "anything").dumps([1]) == "[1]"
