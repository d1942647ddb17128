"""Config tests: validation, hashability (jit-static), YAML parity loader."""

import pytest

from ergodic_exploration_tpu.config import EngineConfig, default_config, load_yaml_config


def test_defaults_validate():
    default_config("cart").validate()
    default_config("omni").validate()


def test_config_is_hashable_and_jit_static():
    cfg = default_config("cart")
    assert hash(cfg) == hash(default_config("cart"))
    assert cfg == default_config("cart")


def test_omni_dims():
    cfg = default_config("omni")
    assert cfg.nu == 4
    assert len(cfg.u_min) == 4


def test_validation_rejects_bad_dims():
    with pytest.raises(ValueError):
        EngineConfig(model="omni").validate()  # default tuples are len 2
    with pytest.raises(ValueError):
        EngineConfig(model="quadrotor").validate()


def test_yaml_loader_accepts_reference_param_names():
    cfg = load_yaml_config(
        {
            "model": "cart",
            "wheel_radius": 0.05,
            "wheel_base": 0.25,
            "dt": 0.2,
            "horizon": 15,
            "num_basis": 8,
            "expl_weight": 30.0,
            "buffer_size": 512,
            "batch_size": 128,
            "control_min": [-2.0, -2.0],
            "control_max": 2.0,
            "r": [1.0, 2.0],
            "boundary_radius": 0.3,
            "frequency": 10.0,  # ROS-only param: ignored
            "map_frame": "map",  # ignored
        }
    )
    assert cfg.cart.wheel_radius == 0.05
    assert cfg.cart.wheel_base == 0.25
    assert cfg.dt == 0.2
    assert cfg.horizon == 15
    assert cfg.num_basis == 8
    assert cfg.ergodic_weight == 30.0
    assert cfg.buffer_capacity == 512
    assert cfg.buffer_batch == 128
    assert cfg.u_min == (-2.0, -2.0)
    assert cfg.u_max == (2.0, 2.0)
    assert cfg.r_diag == (1.0, 2.0)
    assert cfg.boundary_radius == 0.3


_SCALAR_FIELD_SAMPLES = {
    # field -> (yaml value, expected python value) — every non-tuple,
    # non-nested EngineConfig field must round-trip with its declared type.
    "dt": (0.2, 0.2),
    "horizon": (15, 15),
    "num_basis": (8, 8),
    "ergodic_weight": (30.0, 30.0),
    "barrier_weight": (2.5, 2.5),
    "buffer_capacity": (512, 512),
    "buffer_batch": (64, 64),
    "history": ("accumulate", "accumulate"),
    "patch_cells": (48, 48),
    "safety_patch_cells": (24, 24),
    "boundary_radius": (0.3, 0.3),
    "occupied_threshold": (0.7, 0.7),
    "barrier_eps": (0.1, 0.1),
    "barrier_boundary_weight": (10.0, 10.0),
    "barrier_obstacle_weight": (0.1, 0.1),
    "d_safe": (0.4, 0.4),
    "enable_safety": (False, False),
    "val_horizon": (5, 5),
    "val_dt": (0.05, 0.05),
    "precision": ("bf16", "bf16"),
    "shared_maps": (True, True),
    "shared_history_draw": (True, True),
    "validate_shared": (False, False),
    "scan_unroll": (4, 4),
    "mi_frontier_cells": (5, 5),
    "orbit_window": (32, 32),
    "orbit_eps": (0.25, 0.25),
}


@pytest.mark.parametrize("field", sorted(_SCALAR_FIELD_SAMPLES))
def test_yaml_roundtrip_every_scalar_field(field):
    """VERDICT r1 item 8: every scalar EngineConfig field settable from YAML
    with EXACTLY its declared type (bools must not land as floats)."""
    yaml_val, expected = _SCALAR_FIELD_SAMPLES[field]
    cfg = load_yaml_config({"model": "cart", field: yaml_val})
    got = getattr(cfg, field)
    assert got == expected
    assert type(got) is type(expected), (field, type(got))


def test_yaml_scalar_samples_cover_all_fields():
    """If a new scalar field is added to EngineConfig, it must be added to
    the round-trip table above (tuple / nested-dataclass fields excluded)."""
    import dataclasses as dc

    covered = set(_SCALAR_FIELD_SAMPLES) | {"model"}
    for f in dc.fields(EngineConfig):
        default = getattr(EngineConfig(), f.name)
        if isinstance(default, (tuple,)) or dc.is_dataclass(default):
            continue
        assert f.name in covered, f"add {f.name} to _SCALAR_FIELD_SAMPLES"


def test_yaml_bool_strings_and_rejects_garbage():
    assert load_yaml_config({"enable_safety": "false"}).enable_safety is False
    assert load_yaml_config({"shared_maps": 1}).shared_maps is True
    with pytest.raises(ValueError):
        load_yaml_config({"enable_safety": 0.5})


def test_shipped_yaml_configs_load_with_expected_values():
    import dataclasses as dc
    import os

    root = os.path.join(os.path.dirname(__file__), os.pardir)
    cart = load_yaml_config(os.path.join(root, "config", "cart.yaml"))
    assert cart == default_config("cart")
    omni = load_yaml_config(os.path.join(root, "config", "omni.yaml"))
    # omni.yaml deliberately overrides footprint + DWA sampling for the
    # Ridgeback-class platform; everything else matches the defaults.
    assert omni == default_config("omni").replace(
        boundary_radius=0.4,
        dwa=dc.replace(default_config("omni").dwa, samples=(5, 5, 11)),
    )


def test_yaml_loader_from_file(tmp_path):
    p = tmp_path / "omni.yaml"
    p.write_text("model: omni\nwheel_radius: 0.1\nlx: 0.3\nly: 0.2\nhorizon: 25\n")
    cfg = load_yaml_config(str(p))
    assert cfg.model == "omni"
    assert cfg.omni.wheel_radius == 0.1
    assert cfg.horizon == 25
    assert cfg.nu == 4


def test_orbit_window_clamps_to_small_buffers():
    """RingBuffer.count saturates at capacity, so an orbit_window above it
    would make the guard silently inert (round-5 review finding) — the
    guard clamps its effective window to the capacity and stays armed."""
    import jax.numpy as jnp
    import numpy as np

    from ergodic_exploration_tpu.controller import orbit_guard
    from ergodic_exploration_tpu.ops.buffer import RingBuffer

    cfg = default_config("cart").replace(
        buffer_capacity=32, orbit_window=64).validate()
    states = np.tile(np.array([[1.0], [1.0]], np.float32), (1, 32))
    buf = RingBuffer(states=jnp.asarray(states),
                     cursor=jnp.asarray(5, jnp.int32),
                     count=jnp.asarray(32, jnp.int32))
    assert bool(orbit_guard(cfg, buf, jnp.asarray([1.0, 1.0])))
    off = cfg.replace(orbit_window=0)
    assert not bool(orbit_guard(off, buf, jnp.asarray([1.0, 1.0])))


def test_flat_yaml_parser_reads_the_shipped_schema():
    """config/*.yaml load with the standard library alone: scalars, inline
    lists, comments (full-line and trailing), quoted strings, null, bools."""
    from ergodic_exploration_tpu.config import parse_flat_yaml

    text = (
        "# header comment\n"
        "model: omni   # trailing comment\n"
        "dt: 0.1\n"
        "horizon: 20\n"
        "control_min: [-6.0, -6, 6e-1]\n"
        "empty: []\n"
        "frame: 'map # not a comment'\n"
        "batch_size: null\n"
        "enable_safety: false\n"
        "\n"
    )
    parsed = parse_flat_yaml(text)
    assert parsed == {
        "model": "omni", "dt": 0.1, "horizon": 20,
        "control_min": [-6.0, -6, 0.6], "empty": [],
        "frame": "map # not a comment", "batch_size": None,
        "enable_safety": False,
    }
    assert load_yaml_config({"batch_size": parsed["batch_size"]}).buffer_batch is None


def test_flat_yaml_parser_rejects_nested_mappings(tmp_path):
    from ergodic_exploration_tpu.config import parse_flat_yaml

    with pytest.raises(ValueError, match="flat"):
        parse_flat_yaml("dwa:\n  horizon: 10\n")
    p = tmp_path / "bad.yaml"
    p.write_text("model: cart\nr: [1.0, 2.0\n")
    with pytest.raises(ValueError, match="unterminated"):
        load_yaml_config(str(p))
