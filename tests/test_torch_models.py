"""The port's LM stack (``repro_torch.models``) against the reference
(``repro.models``) on the CPU, at smoke sizes.

Inputs are made from a seed with numpy and handed to both packages; the
reference's weights are carried into the port with
``convert.from_reference_params``.  Tolerances, stated per test:

* building blocks in fp32: atol 1e-5 (fp32 sums taken in another order);
* whole models in fp32 (all 10 ``smoke_config``s): rtol 1e-4, atol 1e-5
  on hidden states and logits; greedy tokens equal except at a near tie
  (the reference's logits of the two tokens within that tolerance);
* the qwen3-4b smoke model in bf16: 2e-2·max|x| (a few bf16 ulps at the
  top of the range: both sides round every layer's output to bf16, in
  another order).

The reference is imported inside fixtures, so the card, which has no
JAX, can still collect this file.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, arch_names, get_config,
                                 smoke_config)
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import from_reference_params, to_tensor
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 16


@pytest.fixture(scope="module")
def ref():
    imp = importlib.import_module
    jax = imp("jax")
    return types.SimpleNamespace(
        jax=jax, jnp=imp("jax.numpy"), L=imp("repro.models.layers"),
        MOE=imp("repro.models.moe"), SSM=imp("repro.models.ssm"),
        LM=imp("repro.models.transformer").LM,
        EncDec=imp("repro.models.encdec").EncDec,
        configs=imp("repro.configs"))


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """A dict of numpy arrays as (jax, torch) twins."""
    import jax.numpy as jnp
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


# --------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------- #

def test_norms_rope_and_tanh_gelu(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 24)
    sc, bi = _rand(rng, 24, scale=0.1), _rand(rng, 24, scale=0.1)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-6),
           ref.L.rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-6))
    _close(L.layer_norm(torch.from_numpy(x), torch.from_numpy(sc),
                        torch.from_numpy(bi), 1e-5),
           ref.L.layer_norm(jnp.asarray(x), jnp.asarray(sc),
                            jnp.asarray(bi), 1e-5))
    q = _rand(rng, 2, 7, 3, 16)
    pos = np.tile(np.arange(40, 47, dtype=np.int32), (2, 1))
    _close(L.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 1e6),
           ref.L.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6))
    # jax.nn.gelu's default is the tanh form; the erf form differs by
    # ~1e-3 here, far outside the tolerance
    g = _rand(rng, 64, scale=3.0)
    _close(L.gelu(torch.from_numpy(g)), ref.jax.nn.gelu(jnp.asarray(g)),
           rtol=1e-6, atol=1e-6)
    assert np.abs(L.gelu(torch.from_numpy(g)).numpy()
                  - torch.nn.functional.gelu(torch.from_numpy(g)).numpy()
                  ).max() > 1e-4


def _attn_params(rng, d=32, h=4, g=2, hd=8, qk_norm=True):
    p = {"wq": _rand(rng, d, h, hd, scale=0.2),
         "wk": _rand(rng, d, g, hd, scale=0.2),
         "wv": _rand(rng, d, g, hd, scale=0.2),
         "wo": _rand(rng, h, hd, d, scale=0.2)}
    if qk_norm:
        p["q_norm"] = _rand(rng, hd, scale=0.1)
        p["k_norm"] = _rand(rng, hd, scale=0.1)
    return p


@pytest.mark.parametrize("s,window", [(20, 5), (20, 0), (530, 64)])
def test_attention_prefill(ref, s, window):
    """Causal prefill with and without a window; S = 530 crosses the
    reference's Q_CHUNK = 512 query blocking."""
    jnp = ref.jnp
    rng = np.random.default_rng(s + window)
    pj, pt = _both(_attn_params(rng))
    x = _rand(rng, 2, s, 32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    kw = dict(window=window, num_kv_heads=2, rope=True, rope_theta=1e4,
              norm_eps=1e-6)
    want, _ = ref.L.attention(pj, jnp.asarray(x), positions=jnp.asarray(pos),
                              **kw)
    got, _ = L.attention(pt, torch.from_numpy(x),
                         positions=torch.from_numpy(pos), **kw)
    _close(got, want)


def test_attention_decode_against_cache(ref):
    """Prefill 9 tokens into a 16-slot cache, then 3 decode steps with a
    window of 4: the port attends in GQA groups against the full cache,
    masked by position, as the reference does."""
    jnp = ref.jnp
    rng = np.random.default_rng(3)
    pj, pt = _both(_attn_params(rng, qk_norm=False))
    kw = dict(window=4, num_kv_heads=2, rope=True, rope_theta=1e4,
              norm_eps=1e-6)
    cj = {"k": jnp.zeros((2, 16, 2, 8)), "v": jnp.zeros((2, 16, 2, 8))}
    ct = {"k": torch.zeros(2, 16, 2, 8), "v": torch.zeros(2, 16, 2, 8)}
    x = _rand(rng, 2, 9, 32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, cj = ref.L.attention(pj, jnp.asarray(x), positions=jnp.asarray(pos),
                               cache=cj, cache_pos=jnp.int32(0), **kw)
    got, ct = L.attention(pt, torch.from_numpy(x),
                          positions=torch.from_numpy(pos), cache=ct,
                          cache_pos=0, **kw)
    _close(got, want)
    for step in range(3):
        p0 = 9 + step
        x = _rand(rng, 2, 1, 32)
        pos = np.full((2, 1), p0, np.int32)
        want, cj = ref.L.attention(pj, jnp.asarray(x),
                                   positions=jnp.asarray(pos), cache=cj,
                                   cache_pos=jnp.int32(p0), **kw)
        got, ct = L.attention(pt, torch.from_numpy(x),
                              positions=torch.from_numpy(pos), cache=ct,
                              cache_pos=p0, **kw)
        _close(got, want, what=f"decode step {step}")
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])


def test_cross_attention(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(4)
    pj, pt = _both(_attn_params(rng, g=4, qk_norm=False))
    k, v = _rand(rng, 2, 11, 4, 8), _rand(rng, 2, 11, 4, 8)
    for s in (5, 1):
        x = _rand(rng, 2, s, 32)
        pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
        kw = dict(window=0, num_kv_heads=4, rope=False, rope_theta=1e4,
                  norm_eps=1e-6, causal=False)
        want, _ = ref.L.attention(pj, jnp.asarray(x),
                                  positions=jnp.asarray(pos),
                                  kv_override=(jnp.asarray(k),
                                               jnp.asarray(v)), **kw)
        got, _ = L.attention(pt, torch.from_numpy(x),
                             positions=torch.from_numpy(pos),
                             kv_override=(torch.from_numpy(k),
                                          torch.from_numpy(v)), **kw)
        _close(got, want, what=f"S={s}")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(ref, act):
    jnp = ref.jnp
    rng = np.random.default_rng(5)
    if act == "swiglu":
        p = {"w_gate": _rand(rng, 32, 48, scale=0.2),
             "w_up": _rand(rng, 32, 48, scale=0.2),
             "w_down": _rand(rng, 48, 32, scale=0.2)}
    else:
        p = {"w_in": _rand(rng, 32, 48, scale=0.3),
             "w_out": _rand(rng, 48, 32, scale=0.3)}
    pj, pt = _both(p)
    for s in (7, 1):
        x = _rand(rng, 2, s, 32)
        _close(L.mlp(pt, torch.from_numpy(x)), ref.L.mlp(pj, jnp.asarray(x)))


def _moe_params(rng, d=16, e=4, f=24):
    return {"router": _rand(rng, d, e, scale=0.5),
            "w_gate": _rand(rng, e, d, f, scale=0.2),
            "w_up": _rand(rng, e, d, f, scale=0.2),
            "w_down": _rand(rng, e, f, d, scale=0.2)}


def _ref_route(ref, pj, x, top_k, cap):
    """The reference's routing lines (moe.py:93-113): expert ids, slots
    and the kept mask."""
    jax, jnp = ref.jax, ref.jnp
    b, s, _ = x.shape
    e = pj["router"].shape[-1]
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, pj["router"]), -1)
    _, gate_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(b, s * top_k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(
        b, s, top_k, e) * onehot, axis=-1)
    return np.asarray(gate_idx), np.asarray(pos), np.asarray(pos < cap)


def test_moe_drops_match(ref):
    """capacity_factor = 0.5 forces drops; the same (token, k) pairs go
    to the same experts and slots and the same ones drop, and the output
    and the aux loss agree.  Tied router rows exercise the lower-expert-
    first rule."""
    jnp = ref.jnp
    rng = np.random.default_rng(6)
    p = _moe_params(rng)
    p["router"][:, 3] = p["router"][:, 1]          # experts 1 and 3 tie
    pj, pt = _both(p)
    x = _rand(rng, 2, 24, 16)
    cap = MOE._capacity(24, 4, 2, 0.5)
    assert cap == ref.MOE._capacity(24, 4, 2, 0.5) == 8
    ids, pos, keep = _ref_route(ref, pj, jnp.asarray(x), 2, cap)
    _, _, t_ids, t_pos, t_keep = MOE.route(pt, torch.from_numpy(x),
                                           top_k=2, cap=cap)
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert (~keep).sum() > 0                        # tokens do drop
    tied = (ids == 1).any(-1) & (ids == 3).any(-1)
    assert tied.any() and (ids[tied][:, 0] == 1).all()   # lower first
    want, aux = ref.MOE.moe_ffn(pj, jnp.asarray(x), top_k=2,
                                capacity_factor=0.5)
    got, t_aux = MOE.moe_ffn(pt, torch.from_numpy(x), top_k=2,
                             capacity_factor=0.5)
    _close(got, want)
    _close(t_aux, aux)


def test_moe_windowed_path(ref):
    """S = 2·chunk: two dispatch windows, each with its own capacity."""
    jnp = ref.jnp
    rng = np.random.default_rng(7)
    pj, pt = _both(_moe_params(rng))
    x = _rand(rng, 2, 32, 16)
    want, aux = ref.MOE.moe_ffn(pj, jnp.asarray(x), top_k=2,
                                capacity_factor=1.0, chunk=16)
    got, t_aux = MOE.moe_ffn(pt, torch.from_numpy(x), top_k=2,
                             capacity_factor=1.0, chunk=16)
    _close(got, want)
    _close(t_aux, aux)
    with pytest.raises(ValueError, match="multiple"):
        MOE.moe_ffn(pt, torch.from_numpy(x[:, :30]), top_k=2, chunk=16)


def test_ssd_chunked_with_h0(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(8)
    b, l, h, p, g, n = 2, 24, 4, 8, 2, 16
    xh, Bm, Cm = (_rand(rng, b, l, h, p), _rand(rng, b, l, g, n),
                  _rand(rng, b, l, g, n))
    dt = np.abs(_rand(rng, b, l, h, scale=0.3))
    a_log = np.log(np.linspace(1, 16, h)).astype(np.float32)
    D = _rand(rng, h)
    h0 = _rand(rng, b, h, p, n, scale=0.5)
    args = [xh, dt, a_log, Bm, Cm, D]
    y, hl = ref.SSM._ssd_chunked(*map(jnp.asarray, args), 8,
                                 h0=jnp.asarray(h0))
    ty, thl = SSM._ssd_chunked(*map(torch.from_numpy, args), 8,
                               h0=torch.from_numpy(h0))
    _close(ty, y)
    _close(thl, hl)


def test_causal_conv_and_conv_step(ref):
    jnp = ref.jnp
    rng = np.random.default_rng(9)
    x, w, bb = _rand(rng, 2, 9, 6), _rand(rng, 4, 6), _rand(rng, 6)
    hist = _rand(rng, 2, 3, 6)
    for hh in (None, hist):
        want = ref.SSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(bb),
                                    None if hh is None else jnp.asarray(hh))
        got = SSM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(bb),
                               None if hh is None else torch.from_numpy(hh))
        _close(got, want)
    xt = x[:, :1]
    want, wbuf = ref.SSM._conv_step(jnp.asarray(xt), jnp.asarray(w),
                                    jnp.asarray(bb), jnp.asarray(hist))
    got, tbuf = SSM._conv_step(torch.from_numpy(xt), torch.from_numpy(w),
                               torch.from_numpy(bb), torch.from_numpy(hist))
    _close(got, want)
    _close(tbuf, wbuf)


def test_mamba_block_padding_and_state(ref):
    """Prefill of L = 13 with ssm_chunk 8 (3 inert padded rows) seeded
    from a state, then one decode step: the same outputs and states, the
    conv histories from the unpadded rows."""
    jnp = ref.jnp
    cfg = smoke_config("mamba2-370m")
    rcfg = ref.configs.smoke_config("mamba2-370m")
    gen = torch.Generator().manual_seed(0)
    pt = SSM.init_mamba2(gen, cfg, torch.float32)
    pt["dt_bias"] = torch.full_like(pt["dt_bias"], -1.0)  # larger Δ
    pj = {k: jnp.asarray(v.numpy()) for k, v in pt.items()}
    rng = np.random.default_rng(10)
    st = {"ssm": _rand(rng, 2, cfg.ssm_heads, cfg.ssm_head_dim,
                       cfg.ssm_state, scale=0.3),
          "conv_x": _rand(rng, 2, 3, cfg.d_inner),
          "conv_b": _rand(rng, 2, 3, cfg.ssm_state),
          "conv_c": _rand(rng, 2, 3, cfg.ssm_state)}
    x = _rand(rng, 2, 13, cfg.d_model)
    want, wst = ref.SSM.mamba2_block(pj, jnp.asarray(x), rcfg,
                                     state={k: jnp.asarray(v)
                                            for k, v in st.items()})
    got, tst = SSM.mamba2_block(pt, torch.from_numpy(x), cfg,
                                state={k: torch.from_numpy(v)
                                       for k, v in st.items()})
    _close(got, want)
    for k in st:
        _close(tst[k], wst[k], what=k)
    xt = _rand(rng, 2, 1, cfg.d_model)
    want, wst = ref.SSM.mamba2_block(pj, jnp.asarray(xt), rcfg, state=wst)
    got, tst = SSM.mamba2_block(pt, torch.from_numpy(xt), cfg, state=tst)
    _close(got, want)
    for k in st:
        _close(tst[k], wst[k], what=f"decode {k}")


# --------------------------------------------------------------------- #
# whole models, every architecture
# --------------------------------------------------------------------- #

def _models(ref, name, dtype=None):
    """(config, reference model, its params, the port's model carrying
    them)."""
    cfg = smoke_config(name)
    rcfg = ref.configs.smoke_config(name)
    if dtype:
        cfg, rcfg = cfg.replace(dtype=dtype), rcfg.replace(dtype=dtype)
    rm = ref.EncDec(rcfg) if rcfg.is_encoder_decoder else ref.LM(rcfg)
    params = rm.init(ref.jax.random.PRNGKey(0))
    tm = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    sd = from_reference_params(cfg, params)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return cfg, rm, params, tm


def _tokens_agree(t_logits, r_logits, tol):
    """Greedy tokens equal, except where the reference's logits of the
    two tokens are within ``tol`` (a near tie)."""
    r = np.asarray(r_logits, np.float64)
    t_tok = t_logits.float().numpy().argmax(-1)
    r_tok = r.argmax(-1)
    for i in np.nonzero(t_tok != r_tok)[0]:
        gap = r[i, r_tok[i]] - r[i, t_tok[i]]
        assert gap <= tol, f"row {i}: token {t_tok[i]} vs {r_tok[i]}, " \
                           f"reference gap {gap} > {tol}"


def _run_both(ref, name, dtype=None, steps=4, rtol=RTOL, atol=ATOL,
              rel=None):
    """forward hidden states, prefill logits and ``steps`` greedy decode
    steps (the reference's tokens fed to both); ``rel``: tolerance as a
    share of max|x| instead of rtol/atol."""
    jnp = ref.jnp
    cfg, rm, params, tm = _models(ref, name, dtype)

    def close(got, want, what):
        w = np.asarray(want, np.float32)
        if rel is None:
            _close(got, w, rtol, atol, what)
        else:
            err = np.abs(_np(got) - w).max()
            assert err <= rel * np.abs(w).max(), (what, err)

    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tt, tj = torch.from_numpy(toks), jnp.asarray(toks)
    if cfg.is_encoder_decoder:
        frames = _rand(rng, B, 24, cfg.d_model, scale=0.1)
        enc_r = rm.encode(params, jnp.asarray(frames))
        enc_t = tm.encode(torch.from_numpy(frames))
        close(enc_t, enc_r, "encoder states")
        h_r, _ = rm.decode(params, tj, rm._cross_kv(params, enc_r))
        h_t, _ = tm.decode(tt, tm._cross_kv(enc_t))
        close(h_t, h_r, "decoder hidden")
        rc, rl = rm.prefill(params, jnp.asarray(frames), tj, S + steps)
        tc, tl = tm.prefill(torch.from_numpy(frames), tt, S + steps)
        pos = S
    else:
        pe = None
        if cfg.frontend == "vision_stub":
            pe = _rand(rng, B, cfg.num_patches, cfg.d_model, scale=0.1)
        kw_r = {} if pe is None else {"patch_embeds": jnp.asarray(pe)}
        kw_t = {} if pe is None else {"patch_embeds": torch.from_numpy(pe)}
        h_r, _, aux_r = rm.forward(params, tj, **kw_r)
        h_t, _, aux_t = tm.forward(tt, **kw_t)
        close(h_t, h_r, "forward hidden")
        _close(aux_t, aux_r, what="aux loss")
        max_len = S + steps + (0 if pe is None else cfg.num_patches)
        rc, rl = rm.prefill(params, tj, max_len, **kw_r)
        tc, tl = tm.prefill(tt, max_len, **kw_t)
        pos = S + (0 if pe is None else cfg.num_patches)
    close(tl, rl, "prefill logits")
    tol = (atol + rtol * np.abs(np.asarray(rl)).max() if rel is None
           else rel * np.abs(np.asarray(rl)).max())
    _tokens_agree(tl, rl, 2 * tol)
    for step in range(steps):
        nxt = np.asarray(rl).argmax(-1).astype(np.int32)[:, None]
        rl, rc = rm.decode_step(params, rc, jnp.asarray(nxt),
                                jnp.int32(pos))
        tl, tc = tm.decode_step(tc, torch.from_numpy(nxt), pos)
        close(tl, rl, f"decode step {step}")
        _tokens_agree(tl, rl, 2 * tol)
        pos += 1


@pytest.mark.parametrize("name", arch_names())
def test_arch_matches_reference(ref, name):
    """fp32 smoke config: hidden states, prefill logits and 4 decode
    steps within rtol 1e-4 / atol 1e-5."""
    _run_both(ref, name)


def test_qwen3_smoke_bf16(ref):
    """The qwen3-4b smoke model in its own dtype (bf16): within
    2e-2·max|x|."""
    _run_both(ref, "qwen3-4b", dtype="bfloat16", rel=2e-2)


# --------------------------------------------------------------------- #
# configs, carried weights, guards
# --------------------------------------------------------------------- #

def test_full_configs_match_assignment(ref):
    """The port's config copies carry the published numbers (the
    counterpart of ``test_archs.test_full_configs_match_assignment``),
    field for field equal to the reference's."""
    expect = {
        "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 151936),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 151936),
        "granite-34b": (88, 6144, 48, 1, 49152),
        "gemma3-1b": (26, 1152, 4, 1, 262144),
        "qwen3-4b": (36, 2560, 32, 8, 151936),
        "h2o-danube-1.8b": (24, 2560, 32, 8, 32000),
        "internvl2-1b": (24, 896, 14, 2, 151655),
        "mamba2-370m": (48, 1024, 0, 0, 50280),
        "jamba-1.5-large-398b": (72, 8192, 64, 8, 65536),
        "whisper-base": (6, 512, 8, 8, 51865),
    }
    assert set(expect) == set(ARCHS)
    for name, (l, d, h, kv, v) in expect.items():
        cfg = get_config(name)
        assert (cfg.num_layers, cfg.d_model, cfg.num_heads,
                cfg.num_kv_heads, cfg.vocab_size) == (l, d, h, kv, v), name
        assert vars(cfg) == vars(ref.configs.get_config(name)), name
        assert vars(smoke_config(name)) == vars(
            ref.configs.smoke_config(name)), name


def test_moe_param_counts():
    a = get_config("qwen3-moe-30b-a3b")
    assert abs(a.param_count() / 1e9 - 30.5) < 1.5
    assert abs(a.active_param_count() / 1e9 - 3.3) < 0.5
    b = get_config("jamba-1.5-large-398b")
    assert abs(b.param_count() / 1e9 - 398) < 10
    assert abs(b.active_param_count() / 1e9 - 94) < 6


@pytest.mark.parametrize("name", arch_names())
def test_module_param_count(ref, name):
    """The module holds as many parameters as the reference's pytree; for
    the attention-only families that is ``cfg.param_count()`` plus the
    padded vocab rows (once if tied, twice if not)."""
    cfg = smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    rcfg = ref.configs.smoke_config(name)
    rm = ref.EncDec(rcfg) if rcfg.is_encoder_decoder else ref.LM(rcfg)
    shapes = ref.jax.eval_shape(rm.init, ref.jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in ref.jax.tree.leaves(shapes))
    if cfg.family in ("dense", "moe", "vlm"):
        pad = (model.vocab_padded - cfg.vocab_size) * cfg.d_model
        assert n == cfg.param_count() + pad * (
            1 if cfg.tie_embeddings else 2)


def test_bf16_bits_carried_exactly():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    t = to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  a.view(np.uint16))


def test_cache_overflow_raises_where_reference_clamps(ref):
    """``dynamic_update_slice`` clamps a write past ``max_len`` (here: 4
    tokens at position 6 of an 8-slot cache land at 4..7, overwriting
    positions 4 and 5); the port raises instead."""
    jnp = ref.jnp
    rng = np.random.default_rng(11)
    pj, pt = _both(_attn_params(rng, qk_norm=False))
    kw = dict(window=0, num_kv_heads=2, rope=True, rope_theta=1e4,
              norm_eps=1e-6)
    x = _rand(rng, 2, 4, 32)
    pos = np.tile(np.arange(6, 10, dtype=np.int32), (2, 1))
    cj = {"k": jnp.full((2, 8, 2, 8), 7.0), "v": jnp.full((2, 8, 2, 8), 7.0)}
    _, cj = ref.L.attention(pj, jnp.asarray(x), positions=jnp.asarray(pos),
                            cache=cj, cache_pos=jnp.int32(6), **kw)
    k = np.asarray(cj["k"])
    assert (k[:, :4] == 7.0).all() and (k[:, 4:] != 7.0).all()
    ct = {"k": torch.zeros(2, 8, 2, 8), "v": torch.zeros(2, 8, 2, 8)}
    with pytest.raises(ValueError, match="cache overflow"):
        L.attention(pt, torch.from_numpy(x), positions=torch.from_numpy(pos),
                    cache=ct, cache_pos=6, **kw)
    model = LM(smoke_config("qwen3-4b"), device="cpu")
    with pytest.raises(ValueError, match="cache overflow"):
        model.prefill(torch.zeros(1, 9, dtype=torch.long), max_len=8)


def test_models_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("qwen3-4b", "whisper-base"):
        cfg = smoke_config(name)
        cls = EncDec if cfg.is_encoder_decoder else LM
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", arch_names())
def test_gpu_smoke_model_matches_cpu(cuda, name):
    """The same module on the card and on the CPU (fp32 smoke config):
    forward hidden states within rtol 1e-4 / atol 1e-5."""
    cfg = smoke_config(name)
    model = (EncDec if cfg.is_encoder_decoder else LM)(cfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(_rand(rng, B, 24, cfg.d_model, scale=0.1))
        want = model.decode(toks, model._cross_kv(model.encode(frames)))[0]
        model.to(cuda)
        got = model.decode(toks, model._cross_kv(model.encode(frames)))[0]
    else:
        want = model.forward(toks)[0]
        model.to(cuda)
        got = model.forward(toks)[0]
    _close(got.cpu(), want)
