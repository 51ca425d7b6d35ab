"""The port's JAG and SEIR simulators against the JAX reference, on the CPU.

The reference draws each row's numbers with ``jax.random`` from
``PRNGKey(seed)``; the port takes them as an argument.  The parity tests
make the reference's own draws (the same key splits the reference makes,
one key a day for SEIR), hand them to the port as numpy, and compare with
``jax.vmap`` of the reference on the same rows.

Tolerances, in the norm ``max |port - ref| / max |ref|`` over each row of
each array (NaNs at the same places, and ``failed`` and SEIR's
``peak_day`` exactly):

* JAG at 1e-4 in float32 (``jag.py``'s v**5.8 power law and the burn
  trace's exponentials amplify last-place differences of pow and exp;
  observed 7e-6 over 4,000 rows).
* SEIR at 1e-4 in float64 on both sides: the algorithm.  In float32 at
  1e-3: the reference's ``1 - exp(-force)`` cancels for forces near 1e-7,
  where one ulp of exp is ~10 % of the difference, so a single exp that
  rounds the other way moves a row.  The port rounds that exp once from
  float64; 10 rows of 4,000 then lie between 1e-4 and 3.4e-4, none past
  1e-3.

The invariants of ``tests/test_sims.py`` then run on the port's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import jag_simulate as jag_ref
from repro.sim import seir_simulate as seir_ref
from repro_torch.sim import jag_sample_inputs, jag_simulate, seir_simulate
from repro_torch.sim import rng as R
from repro_torch.sim.epidemic import N_PATCH, T_DAYS, seir_draws
from repro_torch.sim.jag import IMG, N_T, N_VIEWS, jag_draws

def _jag_ref_draws(seeds):
    """jag.py:94 — normal(rng, (4, 16, 16)) with rng = PRNGKey(seed)."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    noise = jax.vmap(lambda k: jax.random.normal(k, (N_VIEWS, IMG, IMG)))(keys)
    return keys, {"noise": np.asarray(noise)}


def _seir_ref_draws(seeds, t_days=T_DAYS):
    """epidemic.py:49-53 and :59 — k1, k2, k3 = split(rng, 3); pop from k1,
    the seeding uniforms from k2, and one split of the carried key a day."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))

    def one(rng):
        k1, k2, k3 = jax.random.split(rng, 3)
        pop = jax.random.normal(k1, (N_PATCH,))
        patch = jax.random.uniform(k2, (N_PATCH,))

        def day(key, _):
            key, sub = jax.random.split(key)
            return key, jax.random.normal(sub, (N_PATCH,))
        _, daily = jax.lax.scan(day, k3, None, length=t_days)
        return pop, patch, daily

    pop, patch, daily = jax.vmap(one)(keys)
    return keys, {"pop": np.asarray(pop), "patch": np.asarray(patch),
                  "daily": np.asarray(daily)}


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _row_rel(got, want):
    """max |got - want| / max |want| over each row; NaNs must coincide."""
    g = got.reshape(len(got), -1).astype(np.float64)
    w = want.reshape(len(want), -1).astype(np.float64)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    num = np.nanmax(np.abs(g - w), 1, initial=0.0)
    den = np.nanmax(np.abs(w), 1, initial=0.0)
    return np.where(num == 0, 0.0, num / np.where(den == 0, 1e-300, den))


def _assert_close(got, want, rtol, keys_exact=()):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        if k in keys_exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            rel = _row_rel(g, w)
            assert rel.max() <= rtol, (k, rel.max(), int(rel.argmax()))


def _jag_rows(n, seed):
    u = np.random.default_rng(seed).random((n, 5)).astype(np.float32)
    # two rows inside the failure region (scale > 1.13, thickness < -0.085)
    u[0] = [0.999, 0.001, 0.5, 0.5, 0.5]
    u[1] = [0.97, 0.05, 0.2, 0.9, 0.1]
    return u


def test_jag_matches_reference_on_its_draws():
    u = _jag_rows(512, 0)
    seeds = np.arange(100, 612)
    keys, draws = _jag_ref_draws(seeds)
    want = jax.vmap(jag_ref)(jnp.asarray(u), keys)
    got = jag_simulate(torch.from_numpy(u), _torch(draws))
    assert float(got["failed"][0]) == 1.0 and float(got["failed"][1]) == 1.0
    _assert_close(got, want, 1e-4, keys_exact=("failed",))


def _seir_rows(n, seed):
    u = np.random.default_rng(seed).random((n, 6)).astype(np.float32)
    u[0] = 0.5
    u[1] = [0.5, 0.5, 0.5, 0.5, 1.0, 0.0]   # strongest, earliest NPI
    return u


def test_seir_matches_reference_on_its_draws():
    u = _seir_rows(512, 1)
    keys, draws = _seir_ref_draws(np.arange(7, 519))
    want = jax.vmap(seir_ref)(jnp.asarray(u), keys)
    got = seir_simulate(torch.from_numpy(u), _torch(draws))
    _assert_close(got, want, 1e-3, keys_exact=("peak_day",))


@pytest.mark.parametrize("t_days", [1, 13, 60])
def test_seir_matches_reference_in_float64(t_days):
    u = _seir_rows(64, 2)
    with jax.enable_x64(True):
        keys, draws = _seir_ref_draws(np.arange(64), t_days)
        want = jax.vmap(lambda a, k: seir_ref(a, k, t_days))(
            jnp.asarray(u, jnp.float64), keys)
        want = {k: np.asarray(v) for k, v in want.items()}
    assert draws["daily"].dtype == np.float64
    got = seir_simulate(torch.from_numpy(u.astype(np.float64)), _torch(draws),
                        t_days)
    _assert_close(got, want, 1e-4, keys_exact=("peak_day",))


# ---------------------------------------------------------------------------
# the counter-based draws
# ---------------------------------------------------------------------------

def test_draws_depend_on_the_row_seed_alone():
    seeds = torch.arange(40, 72)
    whole = jag_draws(seeds)["noise"]
    part = jag_draws(seeds[5:9])["noise"]
    np.testing.assert_array_equal(whole[5:9].numpy(), part.numpy())
    again = seir_draws(seeds)
    for k, v in seir_draws(seeds).items():
        np.testing.assert_array_equal(v.numpy(), again[k].numpy())


def test_draws_have_the_right_moments():
    seeds = torch.arange(4096)
    z = R.normal(seeds, 0, 64)
    u = R.uniform(seeds, 1, 64)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert abs(float(u.mean()) - 0.5) < 0.005
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    # streams and neighbouring seeds are not correlated
    a = R.normal(seeds, 0, 1)[:, 0]
    b = R.normal(seeds, 1, 1)[:, 0]
    c = R.normal(seeds + 1, 0, 1)[:, 0]
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.05
    assert abs(float(torch.corrcoef(torch.stack([a, c]))[0, 1])) < 0.05


def test_words_match_a_python_reference():
    """The int64 split multiply gives MurmurHash3's 32-bit finalizer."""
    seeds = torch.tensor([0, 1, 2**31 - 1, 2**32 - 1, 123456789])
    words = R.bits(seeds, 3, 5)
    for i, s in enumerate(seeds.tolist()):
        salt = R._fmix32_int((3 * 0x9E3779B9 + 0x7F4A7C15) & 0xFFFFFFFF)
        key = R._fmix32_int(((s * 0x9E3779B9) & 0xFFFFFFFF) ^ salt)
        for j in range(5):
            x = R._fmix32_int(((j * 0xCC9E2D51) + key) & 0xFFFFFFFF)
            assert int(words[i, j]) == R._fmix32_int(x ^ key)


# ---------------------------------------------------------------------------
# the invariants of tests/test_sims.py, on the port's own draws
# ---------------------------------------------------------------------------

def _jag(u, seed=0):
    u = torch.as_tensor(np.asarray(u, np.float32)).reshape(-1, 5)
    return jag_simulate(u, jag_draws(torch.full((len(u),), seed)))


def test_jag_shapes_and_finiteness():
    out = _jag(np.full(5, 0.5))
    assert out["burn_rate"].shape == (1, N_T)
    assert out["images"].shape == (1, N_VIEWS, IMG, IMG)
    assert float(out["failed"][0]) == 0.0
    for k, v in out.items():
        assert bool(torch.isfinite(v).all()), k


def test_jag_failure_region():
    out = _jag([0.999, 0.001, 0.5, 0.5, 0.5])
    assert float(out["failed"][0]) == 1.0
    assert not bool(torch.isfinite(out["yield"][0]))
    assert not bool(torch.isfinite(out["tion"][0]))


def test_jag_physics_monotonicities():
    u = np.random.default_rng(9).random((30, 5)).astype(np.float32)
    u_sym = u.copy()
    u_sym[:, 2:4] = 0.5
    y = _jag(u)["yield"].numpy()
    y_sym = _jag(u_sym)["yield"].numpy()
    ok = np.isfinite(y) & np.isfinite(y_sym)
    assert ok.sum() > 20
    # symmetric capsules outperform asymmetric ones at the same drive
    assert (y_sym[ok] >= y[ok] - 1e-6 * y_sym[ok]).all()


def test_jag_row_independent_of_batch():
    u = jag_sample_inputs(1, 8)
    batched = jag_simulate(u, jag_draws(torch.arange(8)))
    single = jag_simulate(u[3:4], jag_draws(torch.tensor([3])))
    for k in batched:
        np.testing.assert_allclose(batched[k][3:4].numpy(), single[k].numpy(),
                                   rtol=1e-6, equal_nan=True, err_msg=k)


def _seir(u, seed=0):
    u = torch.as_tensor(np.asarray(u, np.float32)).reshape(-1, 6)
    return seir_simulate(u, seir_draws(torch.full((len(u),), seed)))


def test_seir_epidemic_properties():
    u = np.full(6, 0.5, np.float32)
    out = _seir(u)
    assert out["daily_cases"].shape == (1, T_DAYS)
    assert float(out["attack_rate"][0]) >= 0
    assert bool((out["daily_cases"] >= -1e-6).all())
    # stronger NPI compliance -> fewer total cases
    u_strong = u.copy()
    u_strong[4], u_strong[5] = 1.0, 0.0      # max compliance, early start
    u_none = u.copy()
    u_none[4] = 0.0
    assert float(_seir(u_strong)["attack_rate"][0]) <= \
        float(_seir(u_none)["attack_rate"][0])


def test_seir_deterministic_given_seed():
    u = np.full(6, 0.4, np.float32)
    a = _seir(u, 5)["daily_cases"]
    b = _seir(u, 5)["daily_cases"]
    assert torch.equal(a, b)
    assert not torch.equal(a, _seir(u, 6)["daily_cases"])
