"""Utility-layer tests: compile cache, viz rendering, checkpoints."""

import os

import jax
import jax.numpy as jnp
import numpy as np


def test_compile_cache_defaults_to_a_fixed_path_in_the_checkout(monkeypatch):
    """Unset JAX_COMPILATION_CACHE_DIR: the cache goes to <repo>/.jax_cache
    (a fixed path, never ~ or a temp name) and JAX is pointed there."""
    from ergodic_exploration_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_persistent_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache") and os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_leaves_the_env_dir_alone(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: nothing is changed — JAX reads the
    variable itself and the cache lives there only."""
    from ergodic_exploration_tpu.utils import compile_cache

    target = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_persistent_cache() == target
    assert compile_cache.enable_persistent_cache("/elsewhere") == target
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.path.exists("/elsewhere")


def test_viz_renders_figure(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ergodic_exploration_tpu.grid import Domain, GridMap
    from ergodic_exploration_tpu.viz import render_scenario

    fig, ax = plt.subplots()
    dom = Domain.create(0, 0, 2, 2)
    g = GridMap.create(np.zeros((20, 20), np.float32), 0, 0, 0.1)
    traj = np.array([[0.2, 0.2, 0.0], [0.5, 0.6, 0.1], [1.0, 1.0, 0.2]])
    render_scenario(ax, dom, grid=g, trajectory=traj, title="t")
    out = tmp_path / "fig.png"
    fig.savefig(str(out))
    plt.close(fig)
    assert out.exists() and out.stat().st_size > 1000


# ------------------------------------------------------------- checkpoint


def test_checkpoint_v2_roundtrip_and_validation(tmp_path):
    """VERDICT r1 item 7: path-keyed leaves, shape validation, version tag."""
    import json
    from typing import NamedTuple

    import pytest

    from ergodic_exploration_tpu.utils.checkpoint import load_pytree, save_pytree

    class State(NamedTuple):
        U: jnp.ndarray
        ck_sum: jnp.ndarray

    st = State(U=jnp.arange(6.0).reshape(2, 3), ck_sum=jnp.ones((2, 3)) * 7)
    p = str(tmp_path / "ck.npz")
    save_pytree(p, st)

    # roundtrip
    back = load_pytree(p, State(jnp.zeros((2, 3)), jnp.zeros((2, 3))))
    np.testing.assert_array_equal(np.asarray(back.U), np.asarray(st.U))
    np.testing.assert_array_equal(np.asarray(back.ck_sum), np.asarray(st.ck_sum))

    # a REORDERED NamedTuple with identical leaf shapes must fail loudly
    # (v1 silently loaded U into ck_sum here)
    class Swapped(NamedTuple):
        ck_sum: jnp.ndarray
        U: jnp.ndarray

    with pytest.raises(ValueError, match="keys do not match"):
        load_pytree(p, Swapped(jnp.zeros((2, 3)), jnp.zeros((2, 3))))

    # wrong shape fails loudly
    with pytest.raises(ValueError, match="shape"):
        load_pytree(p, State(jnp.zeros((3, 2)), jnp.zeros((2, 3))))

    # future format version fails loudly
    data = dict(np.load(p))
    meta = json.loads(str(data["__meta__"]))
    meta["version"] = 99
    data["__meta__"] = np.array(json.dumps(meta))
    p2 = str(tmp_path / "future.npz")
    np.savez(p2, **data)
    with pytest.raises(ValueError, match="version"):
        load_pytree(p2, State(jnp.zeros((2, 3)), jnp.zeros((2, 3))))


def test_checkpoint_legacy_v1_still_loads(tmp_path):
    from ergodic_exploration_tpu.utils.checkpoint import load_pytree

    p = str(tmp_path / "v1.npz")
    np.savez(p, leaf_0000=np.ones((2,)), leaf_0001=np.zeros((3,)))
    tree = load_pytree(p, {"a": jnp.zeros(2), "b": jnp.zeros(3)})
    np.testing.assert_array_equal(tree["a"], np.ones(2))
