"""The port's public names: every name of the JAX package's ``__all__``
resolves in ``modular_audio_pipeline_tpu_torch`` (lazily, from the port's
module of the same name), as the same kind of object."""

import dataclasses
import inspect

import pytest

import modular_audio_pipeline_tpu as jax_pkg
import modular_audio_pipeline_tpu_torch as pkg


def _jax_homes():
    """JAX ``__all__`` names grouped by the module that defines them."""
    groups = {}
    for name in jax_pkg.__all__:
        obj = getattr(jax_pkg, name)
        module = getattr(obj, "__module__", None) or "modular_audio_pipeline_tpu.config"
        if not module.startswith("modular_audio_pipeline_tpu."):  # e.g. a typing alias
            module = "modular_audio_pipeline_tpu.protocols"
        groups.setdefault(module.split(".", 1)[1], []).append(name)
    return groups


GROUPS = _jax_homes()


def test_all_covers_the_jax_package():
    assert set(jax_pkg.__all__) <= set(pkg.__all__)
    assert len(jax_pkg.__all__) == 63 and len(pkg.__all__) == 66
    assert {"TorchWhisperBackend", "ServingPipeline", "BatchDriver"} <= set(pkg.__all__)
    with pytest.raises(AttributeError):
        pkg.NoSuchName  # noqa: B018


@pytest.mark.parametrize("module", sorted(GROUPS))
def test_names_resolve_as_in_the_jax_package(module):
    for name in GROUPS[module]:
        want, got = getattr(jax_pkg, name), getattr(pkg, name)
        if inspect.isclass(want):
            assert inspect.isclass(got), name
            assert got.__name__ == want.__name__
            assert got.__module__.startswith("modular_audio_pipeline_tpu_torch."), name
            if dataclasses.is_dataclass(want):
                assert [f.name for f in dataclasses.fields(got)] == [
                    f.name for f in dataclasses.fields(want)], name
        elif callable(want):
            assert callable(got) and got.__name__ == want.__name__, name
        else:
            assert got == want, name  # DEFAULT_PROMPTS


def test_exceptions_keep_the_hierarchy():
    for name in GROUPS["exceptions"]:
        assert issubclass(getattr(pkg, name), pkg.AudioPipelineError), name
