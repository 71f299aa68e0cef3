"""The model state as a plain-dataclass pytree, and the compile-cache
location rule."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cnmf_e_tpu.models.state import CNMFEState, compact, empty_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_state_pytree_round_trip():
    st = empty_state(5, 6, 7, 11).replace(
        b=jnp.ones((2, 6, 7)), f=jnp.ones((2, 11)))
    leaves, treedef = jax.tree_util.tree_flatten(st)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, CNMFEState)
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # None-valued optional fields stay None through the round trip
    assert back.W is None and back.b is not None


def test_state_replace_is_a_copy():
    st = empty_state(3, 4, 4, 5)
    st2 = st.replace(C=st.C + 2.0, active=jnp.ones(3, bool))
    assert float(st.C.sum()) == 0.0 and float(st2.C.sum()) == 30.0
    assert st2.A is st.A
    with pytest.raises(Exception):
        st.C = st2.C                      # frozen


def test_state_passes_through_jit_and_compact():
    st = empty_state(4, 3, 3, 6).replace(
        active=jnp.asarray([False, True, False, True]),
        C=jnp.arange(24, dtype=jnp.float32).reshape(4, 6))
    out = jax.jit(lambda s: s.replace(C=s.C * 2.0))(st)
    assert isinstance(out, CNMFEState)
    np.testing.assert_array_equal(np.asarray(out.C), 2.0 * np.asarray(st.C))
    c = compact(out)
    np.testing.assert_array_equal(np.asarray(c.active),
                                  [True, True, False, False])
    np.testing.assert_array_equal(np.asarray(c.C[0]), np.asarray(out.C[1]))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(env_dir, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory
    of its own (JAX uses the variable); otherwise the cache goes to the
    fixed ``<repo>/.jax_cache``."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = ("import jax; from cnmf_e_tpu.utils.cache import "
            "enable_compilation_cache as e; r = e(); "
            "print(r); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[-2:]
    assert returned == want and configured == want
