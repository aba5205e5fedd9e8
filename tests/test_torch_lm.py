"""The port's dense-LM serving path against the reference on the same
inputs, for the four dense archs in their reduced float32 configs.

Weights are the reference's ``init_tree`` draws carried over by
``convert.from_jax_lm``; tokens and activations come from numpy with a
seed.  Tolerances: the layers 1e-5; logits and caches 2e-5 of the largest
reference magnitude; the port's prefill-then-decode against its own full
forward 2e-3 (tests/test_models_smoke.py's bound); greedy token ids equal.
On the CPU ``use_kernels=True`` runs the flash kernel's plain version.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import layers as JLY
from repro.models import lm as JLM
from repro.models import model as JM
from repro.models.param import init_tree as jinit_tree
from repro_torch.configs import ARCH_IDS, PORTED_ARCHS, get_config
from repro_torch.convert import from_jax_lm
from repro_torch.launch.steps import build_decode, build_prefill
from repro_torch.models import layers as LY
from repro_torch.models import lm as LM
from repro_torch.models import model as M
from repro_torch.models.param import count_params, leaves

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list(PORTED_ARCHS)
B, S = 2, 32
_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params)."""
    if arch not in _MODELS:
        jcfg = jget_config(arch, reduced=True)
        cfg = get_config(arch, reduced=True)
        jp = jinit_tree(JM.build_decls_any(jcfg), jax.random.PRNGKey(0),
                        jnp.dtype(jcfg.param_dtype))
        _MODELS[arch] = (jcfg, cfg, jp,
                         from_jax_lm(jax.tree.map(np.asarray, jp), cfg, "cpu"))
    return _MODELS[arch]


def _tokens(cfg, seed=3, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(
        np.int32)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_layers_match_reference(arch):
    """rmsnorm, rope_apply, attn_prefill (plain and flash path),
    attn_decode and mlp_apply of layer 0 at 1e-5."""
    jcfg, cfg, jp, p = _model(arch)
    jl, pl = _layer0(jp["stack"]["slot0"]), _layer0(p["stack"]["slot0"])
    rng = np.random.default_rng(1)
    D, hd = cfg.d_model, cfg.hd
    x = rng.standard_normal((B, 20, D)).astype(np.float32)
    tx = torch.from_numpy(x)
    scale = rng.uniform(0.5, 1.5, D).astype(np.float32)
    _close(LY.rmsnorm(tx, torch.from_numpy(scale), cfg.norm_eps),
           JLY.rmsnorm(x, scale, cfg.norm_eps))
    xh = rng.standard_normal((B, 20, cfg.n_heads, hd)).astype(np.float32)
    pos = (np.arange(20)[None] + np.array([[0], [7]])).astype(np.int32)
    _close(LY.rope_apply(torch.from_numpy(xh), torch.from_numpy(pos),
                         cfg.rope_theta),
           JLY.rope_apply(xh, pos, cfg.rope_theta))

    positions = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20)).copy()
    jout, (jk, jv) = JLY.attn_prefill(jl["attn"], x, jcfg, positions, chunk=8)
    for use in (False, True):
        out, (k, v) = LY.attn_prefill(pl["attn"], tx, cfg,
                                      torch.from_numpy(positions), chunk=8,
                                      use_kernels=use)
        _close(out, jout)
        _close(k, jk)
        _close(v, jv)

    cache_k = rng.standard_normal((B, 24, cfg.n_kv, hd)).astype(np.float32)
    cache_v = rng.standard_normal((B, 24, cfg.n_kv, hd)).astype(np.float32)
    x1 = x[:, :1]
    jo, jck, jcv = JLY.attn_decode(jl["attn"], x1, jcfg,
                                   jnp.asarray(11, jnp.int32), cache_k, cache_v)
    o, ck, cv = LY.attn_decode(pl["attn"], torch.from_numpy(x1), cfg, 11,
                               torch.from_numpy(cache_k.copy()),
                               torch.from_numpy(cache_v.copy()))
    _close(o, jo)
    _close(ck, jck)
    _close(cv, jcv)
    _close(LY.mlp_apply(pl["mlp"], tx, cfg), JLY.mlp_apply(jl["mlp"], x, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    """Full-sequence logits (train mode, plain and flash path), prefill
    logits and cache, and one decode step after the prefill, at 2e-5 of
    the reference's scale."""
    jcfg, cfg, jp, p = _model(arch)
    tok = _tokens(cfg)
    want, _, _ = JLM.forward(jcfg, jp, jnp.asarray(tok), chunk=16,
                             mode="train")
    for use in (False, True):
        got, cache = LM.forward(cfg, p, torch.from_numpy(tok).long(),
                                chunk=16, use_kernels=use)
        assert cache is None and got.shape == (B, S, cfg.vocab)
        assert _rel(got, want) <= 2e-5, (use, _rel(got, want))

    jlog, jcache = JM.forward_prefill(jcfg, jp, {"tokens": tok[:, :S - 1]},
                                      S_max=S, chunk=16)
    log, cache = M.forward_prefill(cfg, p, {"tokens": torch.from_numpy(
        tok[:, :S - 1]).long()}, S_max=S, chunk=16)
    assert log.shape == (B, 1, cfg.vocab)
    assert _rel(log, jlog) <= 2e-5
    for kv in ("k", "v"):
        got_kv = cache["stack"]["slot0"][kv]
        assert got_kv.shape == jcache["stack"]["slot0"][kv].shape
        assert _rel(got_kv, jcache["stack"]["slot0"][kv]) <= 2e-5

    def pad(a):
        return np.pad(np.asarray(a), [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])

    jfull = jax.tree.map(pad, jcache)
    jlog2, jcache2 = JM.decode_step_any(jcfg, jp, jfull, tok[:, -1:],
                                        jnp.asarray(S - 1, jnp.int32))
    full = LM.init_cache(cfg, B, S, "cpu")
    for kv in ("k", "v"):
        full["stack"]["slot0"][kv][:, :, :S - 1] = cache["stack"]["slot0"][kv]
    log2, cache2 = M.decode_step_any(cfg, p, full,
                                     torch.from_numpy(tok[:, -1:]).long(),
                                     S - 1)
    assert _rel(log2, jlog2) <= 2e-5
    for kv in ("k", "v"):
        assert _rel(cache2["stack"]["slot0"][kv],
                    jcache2["stack"]["slot0"][kv]) <= 2e-5
    # the port's own consistency: the decoded last token against its full
    # forward (tests/test_models_smoke.py's check)
    full_logits, _ = LM.forward(cfg, p, torch.from_numpy(tok).long(),
                                chunk=16)
    _close(log2[:, 0], full_logits[:, -1], tol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches_reference(arch):
    """Prefill then five greedy steps through ``build_prefill`` /
    ``build_decode`` give the reference's token ids (its forward_prefill +
    decode_step_any loop with jnp.argmax)."""
    jcfg, cfg, jp, p = _model(arch)
    P, steps = 12, 5
    tok = _tokens(cfg, seed=5, n=P)
    jlog, jcache = JM.forward_prefill(jcfg, jp, {"tokens": tok}, S_max=P + steps,
                                      chunk=P)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]),
        jcache)
    jt = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = [np.asarray(jt)]
    for i in range(steps):
        jl, jcache = JM.decode_step_any(jcfg, jp, jcache, jt,
                                        jnp.asarray(P + i, jnp.int32))
        jt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)[:, None]
        want.append(np.asarray(jt))

    logits, raw = build_prefill(cfg, chunk=P)(
        p, {"tokens": torch.from_numpy(tok).long()})
    cache = LM.init_cache(cfg, B, P + steps, "cpu")
    for kv in ("k", "v"):
        cache["stack"]["slot0"][kv][:, :, :P] = raw["stack"]["slot0"][kv]
    t = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    got = [t.numpy()]
    step = build_decode(cfg)
    for i in range(steps):
        t, cache = step(p, cache, t, P + i)
        assert t.dtype == torch.int32 and t.shape == (B, 1)
        got.append(t.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_decls_match_reference(arch):
    """The full configs' parameter and cache declarations equal the
    reference's leaf for leaf (path, shape, initializer), with equal
    counts; nothing is allocated."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.hd, cfg.vocab) == (
        jcfg.n_layers, jcfg.d_model, jcfg.hd, jcfg.vocab)
    is_decl = lambda x: hasattr(x, "init")
    for jd, d in ((JM.build_decls_any(jcfg), M.build_decls_any(cfg)),
                  (JM.cache_decls_any(jcfg, 2, 64),
                   M.cache_decls_any(cfg, 2, 64))):
        jleaves = jax.tree_util.tree_flatten_with_path(jd, is_leaf=is_decl)[0]
        jpaths = ["/".join(k.key for k in path) for path, _ in jleaves]
        ports = leaves(d)
        assert len(ports) == len(jleaves)
        paths = []

        def walk(t, prefix):
            for k in sorted(t):
                if isinstance(t[k], dict):
                    walk(t[k], f"{prefix}{k}/")
                else:
                    paths.append(f"{prefix}{k}")
        walk(d, "")
        assert paths == jpaths
        for (_, jl), pl in zip(jleaves, ports):
            assert (pl.shape, pl.init, pl.scale) == (jl.shape, jl.init,
                                                     jl.scale)
            if jl.dtype is not None:
                assert pl.dtype == jnp.dtype(jl.dtype).name
    assert count_params(M.build_decls_any(cfg)) == jcfg.param_count()
    assert cfg.param_count() == jcfg.param_count()


def test_unported_archs_and_bad_trees_raise():
    for arch in ARCH_IDS:
        if arch not in PORTED_ARCHS:
            with pytest.raises(NotImplementedError, match="A20"):
                get_config(arch)
    jcfg, cfg, jp, _ = _model("qwen15_05b")
    tree = jax.tree.map(np.asarray, jp)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        from_jax_lm(tree, cfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        from_jax_lm(tree, cfg, "cpu")


def test_from_jax_lm_carries_bf16_leaves():
    """A full-precision-policy tree (bf16 leaves, ml_dtypes on the numpy
    side) keeps its bits and dtype."""
    import dataclasses
    jcfg = dataclasses.replace(jget_config("gemma_2b", reduced=True),
                               param_dtype="bfloat16")
    cfg = dataclasses.replace(get_config("gemma_2b", reduced=True),
                              param_dtype="bfloat16")
    jp = jinit_tree(JM.build_decls_any(jcfg), jax.random.PRNGKey(1),
                    jnp.bfloat16)
    p = from_jax_lm(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))


def test_serve_cli_reduced_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--batch", "2", "--prompt-len", "9", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("prefill:") and lines[1].startswith("decode:")
    assert len(ast.literal_eval(lines[3].strip())) == 4
