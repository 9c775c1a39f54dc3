"""``green_kernel="refine"`` in the port against the JAX package, on the
CPU. The port accepts the name where the JAX constructors do and runs the
inner solve for it, as for "auto", "xla", "df32" and "pallas" (the JAX
refine route's refined inverse was slower than the inner solve on the
card at equal or worse green_dev: PERF.md; ROADMAP.md Queue 3,
Divergences).

- Sweep pairs with the same fields and uniforms (JAX's own draws):
  Hubbard L = 4 float32 and SDW opdim 1 real float32 against the JAX
  models on their refine route, whose ``_green_interpret`` is set False so
  they factor with jnp QR (the Pallas kernels off the TPU run in
  interpret mode); SDW opdim 3 native complex (complex128) against the
  JAX model's exact chain (``fermion_repr="complex"``): the JAX
  native-pair refine chain runs its update kernel in interpret mode (94 s
  to compile one sweep pair on the CPU) and does not trace at float64.
  Gates: decisions identical, G within 1e-5 (the float32 storage floor);
  one unequal-time measurement (Hubbard) within 1e-5 of JAX's.
- The route grid: opdim x fermion_matrix x dtype x green_kernel (SDW) and
  dtype x stab_dtype x green_kernel (Hubbard), the port accepting and
  refusing what the JAX constructors do.
- Every accepted ``green_kernel`` name walks the port's "auto" chain
  bitwise, and ``greenKernel`` / ``greenRefineIters`` reach both models
  through the single-run and PT CLIs.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detqmc_tpu.models import hubbard as jh
from detqmc_tpu.models import sdw as js
from detqmc_tpu_torch.convert import sdw_state_from_jax, state_from_jax
from detqmc_tpu_torch.models import hubbard as th
from detqmc_tpu_torch.models import sdw as ts
from detqmc_tpu_torch.models.hubbard import Stack
from tests.test_torch_hubbard import one_torch_thread  # noqa: F401


W = 2
REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---- sweep pairs -------------------------------------------------------------

def _hub_uniforms(keys, m, n, dtype):
    """JAX's per-sweep draw (hubbard.py _sweep): split, then uniform."""
    def draw(key):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (m, n), dtype=dtype)
    return jax.vmap(draw)(keys)


def test_hubbard_refine_sweeps_and_dynamics_match_jax():
    """Hubbard L = 4 float32 with green_kernel="refine": two sweep pairs from
    JAX's state with JAX's uniforms (fields and signs identical, G within
    1e-5), then one unequal-time measurement G(tau, 0) (N = 16, JAX's
    refined dense-RHS solve) within 1e-5 of JAX's. At beta = 1: the JAX
    model keeps its stack's U in float32 (the port's is float64, ROADMAP.md
    Queue 3, Divergences), and at beta = 2 that alone puts JAX's
    refreshed G 1.05e-5 (relative) from the port's."""
    kw = dict(L=4, U=4.0, beta=1.0, m=8, s=4, dtype="float32",
              green_kernel="refine")
    jm = jh.HubbardModel(jh.HubbardConfig(**kw))
    jm._green_interpret = False
    tm = th.HubbardModel(th.HubbardConfig(**kw), device="cpu")
    jst = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(11), W))
    st = state_from_jax(jst)
    st = tm.refresh_from_field(st._replace(stack=Stack(
        *[x.to(torch.float64) for x in st.stack])))
    assert _rel(st.G.numpy(), jst.G) < REL
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    n = tm.cfg.n_sites
    for _ in range(2):
        k1, u_up = _hub_uniforms(jst.key, kw["m"], n, jnp.float32)
        _, u_dn = _hub_uniforms(k1, kw["m"], n, jnp.float32)
        jst, jo = step(jst)
        st, to = tm.sweep_pair(st, measure=True, u01=(
            torch.as_tensor(np.array(u_up)), torch.as_tensor(np.array(u_dn))))
        np.testing.assert_array_equal(st.field.numpy(), np.asarray(jst.field))
        np.testing.assert_array_equal(st.sign.numpy(), np.asarray(jst.sign))
        assert _rel(st.G.numpy(), jst.G) < REL
        np.testing.assert_allclose(to.occupancy.numpy(),
                                   np.asarray(jo.occupancy), atol=1e-5)
    Gtau = tm.time_displaced_greens(st.field)
    Gtau_j = jax.vmap(jm.time_displaced_greens)(jst.field)
    assert Gtau.shape == Gtau_j.shape
    assert _rel(Gtau.numpy(), Gtau_j) < REL


@functools.lru_cache(maxsize=None)
def _sdw_slice_draws(N, op, dtype):
    """One slice's box draws of every walker (SDWModel.
    _draw_proposal_randoms), jitted once per shape and dtype."""
    def one_slice(key):
        key, k_prop, k_acc = jax.random.split(key, 3)
        return key, (jax.random.uniform(k_acc, (N,), dtype=dtype),
                     jax.random.uniform(k_prop, (N, op), dtype=dtype,
                                        minval=-1.0, maxval=1.0))
    return jax.jit(jax.vmap(one_slice))


def _sdw_sweep_draws(cfg, keys, up, dtype):
    draw = _sdw_slice_draws(cfg.n_sites, cfg.opdim, dtype)
    per_slice = []
    for _ in range(cfg.m):
        keys, d = draw(keys)
        per_slice.append([np.asarray(x) for x in d])
    if not up:
        per_slice = per_slice[::-1]
    t = [torch.as_tensor(np.stack([d[k] for d in per_slice], axis=1))
         for k in range(2)]
    return keys, (t[0], (t[1],))


@pytest.mark.parametrize("case", ["opdim1-real-f32", "opdim3-native-c128"])
def test_sdw_refine_sweeps_match_jax(case):
    """SDW with green_kernel="refine", two sweep pairs from JAX's state with
    JAX's draws: opdim 1 real float32 against the JAX model's refine
    route, opdim 3 complex128 against the JAX model's exact chain (see the
    module docstring). Fields identical, acceptance identical, G within
    1e-5; the port's phase exactly 1."""
    opdim, dtype = (1, "float32") if case.startswith("opdim1") else (
        3, "float64")
    kw = dict(L=2, opdim=opdim, r=0.5, beta=1.0, m=8, s=4, dtype=dtype)
    if opdim == 1:
        jm = js.SDWModel(js.SDWConfig(green_kernel="refine", **kw))
        jm._green_interpret = False
    else:
        jm = js.SDWModel(js.SDWConfig(fermion_repr="complex", **kw))
    tm = ts.SDWModel(ts.SDWConfig(green_kernel="refine", **kw), device="cpu")
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    jst = jax.jit(jax.vmap(jm.init_state))(
        jax.random.split(jax.random.key(5), W))
    st = sdw_state_from_jax(jst)
    st = tm.refresh_from_field(st._replace(
        stack_d=st.stack_d.to(torch.float64),
        stack_V=st.stack_V.to(tm.vdtype)))
    assert _rel(st.G.numpy(), jst.G) < REL
    step = jax.jit(jax.vmap(lambda s: jm.sweep_pair(s, measure=True)))
    for _ in range(2):
        keys, d_up = _sdw_sweep_draws(tm.cfg, jst.key, True, jdt)
        _, d_dn = _sdw_sweep_draws(tm.cfg, keys, False, jdt)
        jst, jo = step(jst)
        st, to = tm.sweep_pair(st, measure=True, draws=(d_up, d_dn))
        np.testing.assert_array_equal(st.phi.numpy(), np.asarray(jst.phi))
        np.testing.assert_array_equal(to.acceptance.numpy(),
                                      np.asarray(jo.acceptance))
        assert _rel(st.G.numpy(), jst.G) < REL
    assert torch.equal(st.phase, torch.ones_like(st.phase))


# ---- the route grid ----------------------------------------------------------

def _builds(ctor):
    try:
        ctor()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__
    return "ok"


def test_refine_route_grid_matches_jax():
    """The constructors accept and refuse the same configurations. SDW:
    opdim x fermion_matrix x dtype x green_kernel (auto, xla, refine), the
    JAX model at fermion_repr="native_pair" where opdim >= 2 (the port's
    one complex representation) and "auto" at opdim 1. Hubbard: dtype x
    stab_dtype x green_kernel."""
    grid = itertools.product((1, 2, 3), ("auto", "full", "reduced"),
                             ("float32", "float64"),
                             ("auto", "xla", "refine"))
    seen = set()
    for opdim, fm, dt, gk in grid:
        kw = dict(L=2, m=4, s=2, opdim=opdim, fermion_matrix=fm, dtype=dt,
                  green_kernel=gk)
        repr_ = "native_pair" if opdim >= 2 else "auto"
        want = _builds(lambda: js.SDWModel(js.SDWConfig(fermion_repr=repr_,
                                                        **kw)))
        got = _builds(lambda: ts.SDWModel(ts.SDWConfig(**kw), device="cpu"))
        assert got == want, (kw, got, want)
        seen.add((gk, got))
    assert ("refine", "ok") in seen and ("refine", "ValueError") in seen
    for dt, sd, gk in itertools.product(("float32", "float64"),
                                        ("auto", "float32", "float64"),
                                        ("auto", "xla", "pallas", "refine")):
        kw = dict(L=2, m=4, s=2, dtype=dt, stab_dtype=sd, green_kernel=gk)
        want = _builds(lambda: jh.HubbardModel(jh.HubbardConfig(**kw)))
        got = _builds(lambda: th.HubbardModel(th.HubbardConfig(**kw),
                                              device="cpu"))
        assert got == want, (kw, got, want)


NAMES = [("hubbard", {}, gk) for gk in ("xla", "pallas", "refine")] + [
    ("sdw", dict(opdim=3), gk) for gk in ("xla", "df32", "pallas", "refine")
] + [("sdw", dict(opdim=1), "refine")]


@pytest.mark.parametrize("model,kw,name", NAMES,
                         ids=[f"{m}{kw.get('opdim', '')}-{n}"
                              for m, kw, n in NAMES])
def test_every_green_kernel_name_walks_the_auto_chain(model, kw, name):
    """Each accepted name is the inner solve: one float32 sweep pair (L =
    2) from the same seed walks the "auto" chain bitwise (fields, G,
    green_dev and observables)."""
    mod = th if model == "hubbard" else ts
    cfg = functools.partial(mod.HubbardConfig if model == "hubbard"
                            else mod.SDWConfig, L=2, beta=1.0, m=8, s=4,
                            dtype="float32", **kw)
    Model = mod.HubbardModel if model == "hubbard" else mod.SDWModel
    runs = []
    for gk in ("auto", name):
        m = Model(cfg(green_kernel=gk), device="cpu")
        st = m.init_state(W, torch.Generator().manual_seed(3))
        st, obs = m.sweep_pair(st, measure=True,
                               generator=torch.Generator().manual_seed(4))
        runs.append((st, obs))
    (s0, o0), (s1, o1) = runs
    for a, b in zip(tuple(s0) + tuple(o0), tuple(s1) + tuple(o1)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_refine_keys_reach_both_models_through_the_clis(tmp_path,
                                                        monkeypatch):
    """greenKernel=refine and greenRefineIters reach the models' configs
    through the single-run CLIs (detqmc-hubbard-torch, detqmc-sdw-torch)
    and the PT CLI (Hubbard over stagger_h, SDW over r), and each run
    ends with exit 0."""
    from detqmc_tpu_torch.cli import main_hubbard, main_pt, main_sdw

    seen = []

    def recording(cls):
        real = cls.__init__

        def init(self, cfg, *a, **k):
            seen.append((cfg.green_kernel, cfg.green_refine_iters))
            real(self, cfg, *a, **k)
        monkeypatch.setattr(cls, "__init__", init)

    recording(th.HubbardModel)
    recording(ts.SDWModel)
    base = ["L=2", "beta=1", "m=8", "s=4", "sweeps=2", "thermalization=1",
            "greenKernel=refine", "greenRefineIters=2", "device=cpu"]
    runs = [(main_hubbard.main, base + ["walkers=2"], {}),
            (main_sdw.main, base + ["walkers=2", "opdim=2"], {}),
            (main_pt.main, base + ["values=0,0.1", "controlParameter="
                                   "stagger_h", "model=hubbard"], {}),
            (main_pt.main, ["--conf", "examples/pt_sdw_r_grid.conf"]
             + base + ["values=0.5,1.0", "ptEnsembles=1"],
             {"default_model": "sdw"})]
    for i, (main, args, kw) in enumerate(runs):
        seen.clear()
        assert main(args + [f"outdir={tmp_path / str(i)}"], **kw) == 0
        assert seen and set(seen) == {("refine", 2)}, (i, seen)
