"""Decoder-only LM covering the dense / moe / ssm / hybrid / vlm families.
Port of ``src/repro/models/transformer.py`` as an ``nn.Module``.

One class, three layer-stack layouts, each an ``nn.ModuleList`` with one
entry per layer (the reference stacks them along a leading axis and
scans):

  * uniform attention stack (dense, moe, vlm): ``layers[l]`` holds
    ``attn``, ``ffn``, ``ln1``, ``ln2``; the window is a per-layer
    integer (gemma3's 5:1 local:global, danube's SWA);
  * uniform mamba stack (ssm): ``layers[l]`` holds ``mamba`` and ``ln``;
  * hybrid period blocks (jamba): ``layers[b]`` holds the block's
    sub-stacks ``attn``, ``mamba[P-1]``, ``mlp[...]``, ``moe[...]``,
    ``ln1`` (P, d) and ``ln2`` (P, d), exactly the reference's.

The weights live in the module, so ``forward``, ``loss``, ``prefill``
and ``decode_step`` take no ``params`` argument.  The serving entry
points run under ``torch.inference_mode()``; ``loss`` runs the shared
``forward`` under autograd, with ``remat`` at the reference's
``jax.checkpoint`` points (``layers.remat``).  ``unroll`` (a scan knob)
has no counterpart.  Decode caches keep the reference's stacked layout
(a leading layer axis) and are updated in place.

Parameters are created frozen (``requires_grad=False``), so serving
builds no graph; ``train.step.make_train_step`` makes them trainable.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from ..distributed import actctx, fsdp, tp

f32 = torch.float32
AUX_WEIGHT = 0.01          # the MoE aux loss's weight in ``LM.loss``


def check_not_tp(module) -> None:
    """Refuse a forward, outside a data row of a mesh, of a module that
    holds one TP rank's weights (placed over a model axis > 1)."""
    if getattr(module, "tp_size", 1) > 1 and actctx.row_ranks() is None:
        raise ValueError(
            "this module holds one TP rank's weights (placed over a model "
            "axis > 1): run it through serve.step's make_prefill / "
            "make_decode(..., mesh=) or train.step.make_train_step(..., "
            "mesh=)")


def serves_rows(cache) -> bool:
    """Whether a forward runs over the running data row's ranks: inside
    a tensor-parallel row, or with a mesh's cache (a row's
    ``fsdp.RowCache`` in prefill, the mesh's ``fsdp.MeshCache`` in
    decode).  Inside such a row a cache must be a view of a placed
    one."""
    if isinstance(cache, (fsdp.RowCache, fsdp.MeshCache)):
        return True
    if actctx.tp_ranks() is None:
        return False
    if cache is not None:
        raise ValueError("a cache under tensor parallelism must be a data "
                         "row's view of a placed cache (fsdp.RowCache: "
                         "serve.step's mesh builders make one)")
    return True


def embed_tp(embeds, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """The embedding lookup over a row's TP ranks: rank j looks up the
    tokens among its rows of the vocabulary (``embeds[j]``, a cut of the
    ``vocab`` rows, or all of them where the spec does not cut it) and
    zeroes the others; *g* joins the ranks (one nonzero term a token, so
    the sum is exact).  Returns the rows on rank 0's device."""
    if embeds[0].shape[0] == vocab:
        return embeds[0][tokens.to(embeds[0].device)]

    def lookup(j):
        e = embeds[j]
        tok = tokens.to(e.device).long() - j * e.shape[0]
        inside = (tok >= 0) & (tok < e.shape[0])
        rows = e[tok.clamp(0, e.shape[0] - 1)]
        return rows * inside[..., None].to(rows.dtype)
    return tp.reduce_from_ranks(tp.run_ranks(range(len(embeds)), lookup,
                                             inputs=lambda j: embeds[j]))


def sublayer_tp(xs, axis, norm, run):
    """One sublayer over the running row's TP ranks: ``tp.enter`` (``norm(x,
    rank)``), ``run(rank, input) -> output`` on the ranks that compute
    it, ``tp.leave`` and the residual add.  ``run.partial``: whether the
    outputs are row-parallel partials."""
    devices = actctx.tp_devices()
    hs = tp.enter(xs, axis, norm, devices)
    outs = tp.run_ranks(tp.ranks_to_run(run.partial, axis, len(devices)),
                        lambda j: run(j, hs[j]), inputs=lambda j: hs[j])
    return add_tp(xs, axis, outs, run.partial)


def add_tp(xs, axis, outs, partial: bool):
    """The residual ``xs`` plus a sublayer's update from the ranks'
    outputs (``tp.leave``; outputs of ranks that need not run are
    dropped): row-parallel partials, fp32, are summed in fp32 and cast
    once to the residual's dtype."""
    outs = outs[:len(tp.ranks_to_run(partial, axis, len(outs)))]
    return [x + u.to(x.dtype)
            for x, u in zip(xs, tp.leave(outs, axis, partial))]


def attention_run(cfg, ps, positions, *, window: int, rope: bool,
                  causal: bool = True, kv=None, caches=None, cache_pos=None):
    """A ``sublayer_tp`` runner: rank j's attention heads (``ps[j]``, its
    weights; ``kv``: the ranks' copies of a cross-attention's K/V;
    ``caches``: each rank's whole copy of a self-attention cache, written
    at ``cache_pos``)."""
    local = ps[0]["wq"].shape[-2]

    def run(j, h):
        a, _ = L.attention(
            ps[j], h, positions=positions.to(h.device), window=window,
            num_kv_heads=cfg.num_kv_heads, rope=rope,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, causal=causal,
            kv_override=None if kv is None else kv[j],
            cache=None if caches is None else caches[j],
            cache_pos=cache_pos, num_heads=cfg.num_heads,
            head_offset=j * local if local < cfg.num_heads else 0)
        return a
    run.partial = local < cfg.num_heads
    return run


def attention_tp(cfg, xs, axis, ps, norm, positions, *, window: int,
                 rope: bool, causal: bool = True, kv=None, cache=None,
                 cache_pos=None, write: bool = True):
    """The attention sublayer over the running row's ranks:
    ``sublayer_tp(xs, axis, norm, attention_run(...))``, with a serving
    cache — ``cache``, the layer's ``layers.SeqKV`` in prefill, or its
    ``layers.MeshKV`` in a weight-stationary decode
    (``layers.attention_mesh_decode``; ``write`` False: a
    cross-attention's, read only).  Prefill, where the mesh cuts the
    cache's sequence, attends over the fresh K/V, as training does, and
    writes the K/V of every kv head (from rank 0's input) into the pieces
    that hold the prompt's positions; where the sequence is whole, every
    rank writes its own copy in its ``layers.attention`` (every rank
    runs, so that each copy is written)."""
    devices = actctx.tp_devices()
    hs = tp.enter(xs, axis, norm, devices)
    t = len(devices)
    local = ps[0]["wq"].shape[-2]
    partial = local < cfg.num_heads
    caches = None
    if isinstance(cache, L.MeshKV):
        outs = L.attention_mesh_decode(
            ps, hs, cache, positions=positions, window=window,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            rope=rope, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            causal=causal, cache_pos=cache_pos if write else None)
        return add_tp(xs, axis, outs, partial)
    if cache is not None and cache.spread:
        L.write_kv(cache, *L.cache_kv(
            ps[0], hs[0], positions=positions, rope=rope,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            dtype=cache.k[0].dtype), int(cache_pos))
    elif cache is not None:
        caches = [{"k": k, "v": v} for k, v in zip(cache.k, cache.v)]
    run = attention_run(cfg, ps, positions, window=window, rope=rope,
                        causal=causal, kv=kv, caches=caches,
                        cache_pos=cache_pos)
    outs = tp.run_ranks(range(t) if caches is not None
                        else tp.ranks_to_run(partial, axis, t),
                        lambda j: run(j, hs[j]), inputs=lambda j: hs[j])
    return add_tp(xs, axis, outs, partial)


def mlp_run(cfg, ps):
    """A ``sublayer_tp`` runner: rank j's FFN columns and rows."""
    w = ps[0]["w_gate"] if "w_gate" in ps[0] else ps[0]["w_in"]
    partial = w.shape[-1] < cfg.d_ff

    def run(j, h):
        return L.mlp(ps[j], h, partial)
    run.partial = partial
    return run


def head_loss_tp(hiddens, heads, labels, mask, vocab: int) -> torch.Tensor:
    """The cross entropy of a TP row: vocabulary-parallel where the spec
    cuts the head, else rank 0's whole head on its copy."""
    if heads[0].shape[1] == vocab:
        return L.chunked_ce_loss(hiddens[0], heads[0], labels, mask)
    return L.vocab_parallel_ce_loss(hiddens, heads, labels, mask)


def logits_tp(hiddens, heads, padded: int, vocab: int):
    """Fp32 logits of a TP row's last hidden states (``hiddens[j]``
    (B, d), rank j's copy): each rank's columns of a head the spec cuts
    by vocabulary (``heads[j]`` (d, V_j)), the padded columns dropped (a
    rank may keep none), else rank 0's whole row alone.  The greedy token
    is ``tp.argmax_over_ranks`` of them: no rank needs the whole row."""
    if heads[0].shape[1] == padded:
        return [L.mm_f32(hiddens[0], heads[0])[:, :vocab]]
    out, off = [], 0
    for h, w in zip(hiddens, heads):
        keep = max(0, min(w.shape[1], vocab - off))
        out.append(L.mm_f32(h, w[:, :keep]))
        off += w.shape[1]
    return out


# --------------------------------------------------------------------- #
# parameters: the reference's pytree as a module tree
# --------------------------------------------------------------------- #

def register_tree(module: nn.Module, tree: Dict) -> None:
    """Register a nested dict on ``module``: tensors become frozen
    parameters, dicts ``ParamTree``s, lists ``nn.ModuleList``s of
    ``ParamTree``s.  State-dict names follow the reference's pytree keys
    with list positions in between (``layers.3.attn.wq``)."""
    for name, value in tree.items():
        if isinstance(value, dict):
            module.add_module(name, ParamTree(value))
        elif isinstance(value, (list, tuple)):
            module.add_module(name, nn.ModuleList(
                [ParamTree(v) for v in value]))
        else:
            module.register_parameter(
                name, nn.Parameter(value, requires_grad=False))


class ParamTree(nn.Module):
    """A nested mapping of parameters that reads like the reference's
    pytree: ``p["wq"]``, ``"q_norm" in p``, ``p["mamba"][i]``."""

    def __init__(self, tree: Dict):
        super().__init__()
        register_tree(self, tree)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            "device='cpu' to run the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def shifted_labels(tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token labels (the tokens shifted left, a zero appended) and
    the mask that leaves the last position out."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.ones(labels.shape, dtype=torch.bool, device=tokens.device)
    mask[:, -1] = False
    return labels, mask


class LM(nn.Module):
    """``LM(cfg, device="cuda", seed=0)``: random weights with the
    reference's distributions, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s bits;
    carry the reference's weights with ``convert.from_reference_params``
    and ``load_state_dict``).  Raises without a card unless
    ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.is_encoder_decoder:
            raise ValueError("use encdec.EncDec for whisper")
        dev = check_device(device)
        self.cfg = cfg
        self.dtype = L._dtype(cfg.dtype)
        # vocab padded to a 256 multiple (pad rows are unused embeddings)
        self.vocab_padded = -(-cfg.vocab_size // 256) * 256
        with torch.no_grad():
            register_tree(self, self._init_tree(seeded_generator(dev, seed)))

    # ------------------------------------------------------------------ #
    # init
    # ------------------------------------------------------------------ #

    def _init_tree(self, gen: torch.Generator) -> Dict:
        cfg, dt = self.cfg, self.dtype
        zeros = lambda *shape: torch.zeros(shape, dtype=dt,
                                           device=gen.device)
        tree: Dict = {"embed": L.init_embedding(gen, self.vocab_padded,
                                                cfg.d_model, dt),
                      "final_norm": zeros(cfg.d_model)}
        if not cfg.tie_embeddings:
            tree["lm_head"] = L.init_embedding(
                gen, self.vocab_padded, cfg.d_model, dt).t().contiguous()

        def attn_p():
            return L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim,
                                    cfg.qk_norm, dt)

        def ffn_p(l):
            if cfg.is_moe_layer(l):
                return MOE.init_moe(gen, cfg.d_model, cfg.num_experts,
                                    cfg.moe_d_ff, dt)
            return L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt)

        if cfg.family == "ssm":
            tree["layers"] = [{"mamba": SSM.init_mamba2(gen, cfg, dt),
                               "ln": zeros(cfg.d_model)}
                              for _ in range(cfg.num_layers)]
            return tree

        if cfg.attn_period:  # hybrid (jamba)
            P = cfg.attn_period
            blocks = []
            for b in range(cfg.num_layers // P):
                blk = {"attn": attn_p(),
                       "mamba": [SSM.init_mamba2(gen, cfg, dt)
                                 for _ in range(P - 1)],
                       "mlp": [], "moe": []}
                for j in range(P):
                    l = b * P + j     # init uses the global layer index
                    if cfg.is_moe_layer(l):
                        blk["moe"].append(MOE.init_moe(
                            gen, cfg.d_model, cfg.num_experts,
                            cfg.moe_d_ff, dt))
                    else:
                        blk["mlp"].append(L.init_mlp(
                            gen, cfg.d_model, cfg.d_ff, cfg.act, dt))
                blk["ln1"] = zeros(P, cfg.d_model)
                blk["ln2"] = zeros(P, cfg.d_model)
                blocks.append(blk)
            tree["layers"] = blocks
            return tree

        tree["layers"] = [{"attn": attn_p(), "ffn": ffn_p(l),
                           "ln1": zeros(cfg.d_model),
                           "ln2": zeros(cfg.d_model)}
                          for l in range(cfg.num_layers)]
        return tree

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------ #
    # layer bodies
    # ------------------------------------------------------------------ #

    def _attn_layer(self, p, x, positions, window, cache, cache_pos):
        cfg = self.cfg
        p = actctx.gather_params(p)   # inside the region remat recomputes
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a, new_cache = L.attention(
            p["attn"], h, positions=positions, window=window,
            num_kv_heads=cfg.num_kv_heads, rope=cfg.rope,
            rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
            cache=cache, cache_pos=cache_pos)
        x = x + a
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if "router" in p["ffn"]:
            f, aux = MOE.moe_ffn(p["ffn"], h, top_k=cfg.experts_per_token,
                                 capacity_factor=cfg.capacity_factor,
                                 chunk=cfg.moe_dispatch_chunk)
        else:
            f, aux = L.mlp(p["ffn"], h), self._zero()
        return x + f, new_cache, aux

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=f32, device=self.device)

    # ------------------------------------------------------------------ #
    # forward (train / prefill / decode share one driver)
    # ------------------------------------------------------------------ #

    def forward(self, tokens: torch.Tensor, *,
                patch_embeds: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None,
                cache_pos: Optional[int] = None, remat: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Returns (hidden (B,S,d), cache, aux_loss).  No ``params``
        argument: the weights live in the module.  ``cache`` is updated
        in place and returned.  Runs under whatever grad mode the caller
        set; ``remat`` recomputes each layer (each hybrid block, and each
        of its sublayers) in the backward pass.  Over a data row's ranks
        (a tensor-parallel row, or a mesh's ``fsdp.RowCache``; this module
        is rank 0's) ``hidden`` is each rank's copy (``_forward_tp``)."""
        cfg = self.cfg
        if serves_rows(cache):
            hiddens, aux = self._forward_tp(tokens.to(self.device),
                                            patch_embeds, cache, cache_pos,
                                            remat)
            return hiddens, cache, aux
        check_not_tp(self)
        x = self.embed[tokens.to(self.device)].to(self.dtype)
        if patch_embeds is not None:  # vlm stub prefix
            x = torch.cat([patch_embeds.to(self.device, self.dtype), x],
                          dim=1)
        x = actctx.shard(x, "btd")  # re-anchor batch sharding post-gather
        b, s, _ = x.shape
        start = 0 if cache_pos is None else int(cache_pos)
        positions = (start + torch.arange(s, device=self.device)
                     )[None, :].expand(b, s)

        if cfg.family == "ssm":
            x = self._forward_ssm(x, cache, remat)
            aux = self._zero()
        elif cfg.attn_period:
            x, aux = self._forward_hybrid(x, positions, cache, cache_pos,
                                          remat)
        else:
            x, aux = self._forward_uniform(x, positions, cache, cache_pos,
                                           remat)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        return x, cache, aux

    def _forward_uniform(self, x, positions, cache, cache_pos, remat):
        aux = self._zero()
        for l, p in enumerate(self.layers):
            x = actctx.shard(x, "btd_sp" if x.shape[1] > 1 else "btd")
            c = None if cache is None else {"k": cache["k"][l],
                                            "v": cache["v"][l]}
            args = (p, x, positions, self.cfg.layer_window(l, x.shape[1]),
                    c, cache_pos)
            x, _, a = (L.remat(self._attn_layer, *args) if remat
                       else self._attn_layer(*args))
            aux = aux + a
        return x, aux

    def _ssm_layer(self, p, x):
        p = actctx.gather_params(p)   # inside the region remat recomputes
        y, _ = SSM.mamba2_block(p["mamba"],
                                L.rms_norm(x, p["ln"], self.cfg.norm_eps),
                                self.cfg)
        return x + y

    def _forward_ssm(self, x, cache, remat):
        cfg = self.cfg
        for l, p in enumerate(self.layers):
            x = actctx.shard(x, "btd_fsdp" if cache is None
                             or x.shape[1] > 1 else "btd")
            if cache is None:
                x = (L.remat(self._ssm_layer, p, x) if remat
                     else self._ssm_layer(p, x))
                continue
            p = actctx.gather_params(p)
            h = L.rms_norm(x, p["ln"], cfg.norm_eps)
            y, new_st = SSM.mamba2_block(p["mamba"], h, cfg,
                                         state={k: v[l]
                                                for k, v in cache.items()})
            for k, v in new_st.items():
                cache[k][l].copy_(v)
            x = x + y
        return x

    def _forward_hybrid(self, x, positions, cache, cache_pos, remat):
        aux = self._zero()
        for bi, p in enumerate(self.layers):
            x = actctx.shard(x, "btd_fsdp" if x.shape[1] > 1 else "btd")
            args = (p, x, positions, cache, cache_pos, bi, remat)
            x, a = (L.remat(self._hybrid_block, *args) if remat
                    else self._hybrid_block(*args))
            aux = aux + a
        return x, aux

    def _hybrid_block(self, p, x, positions, cache, cache_pos, bi, remat):
        """One period block: P sublayers, each a mixer (attention at
        ``attn_index``, else mamba) and an FFN (MoE on the period-aligned
        pattern).  With ``remat`` and no cache each mixer and FFN is
        recomputed on its own inside the block's recompute (the
        reference's nested ``jax.checkpoint``).  Each mixer and FFN gathers
        its own weights inside the region it recomputes (the reference
        gathers the block's at its top, inside the block's checkpoint;
        here a closure over the block's gathered weights would keep them
        alive through the sublayers' checkpoints until the backward)."""
        cfg = self.cfg
        aux = self._zero()
        gather = actctx.gather_params
        mi = di = ei = 0
        for j in range(cfg.attn_period):
            gl_moe = cfg.is_moe_layer(j)  # period-aligned pattern

            def mixer(x, j=j, mi=mi):
                h = L.rms_norm(x, p["ln1"][j], cfg.norm_eps)
                if j == cfg.attn_index:
                    c_j = None if cache is None else {
                        "k": cache["attn"]["k"][bi],
                        "v": cache["attn"]["v"][bi]}
                    a, _ = L.attention(
                        gather(p["attn"]), h, positions=positions, window=0,
                        num_kv_heads=cfg.num_kv_heads, rope=cfg.rope,
                        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        cache=c_j, cache_pos=cache_pos)
                    return x + a
                c_j = None if cache is None else {
                    k: v[bi, mi] for k, v in cache["mamba"].items()}
                a, nc = SSM.mamba2_block(gather(p["mamba"][mi]), h, cfg,
                                         state=c_j)
                if nc is not None:
                    for k, v in nc.items():
                        cache["mamba"][k][bi, mi].copy_(v)
                return x + a

            def ffn(x, j=j, gl_moe=gl_moe, di=di, ei=ei):
                h = L.rms_norm(x, p["ln2"][j], cfg.norm_eps)
                if gl_moe:
                    f, a2 = MOE.moe_ffn(
                        gather(p["moe"][ei]), h, top_k=cfg.experts_per_token,
                        capacity_factor=cfg.capacity_factor,
                        chunk=cfg.moe_dispatch_chunk)
                else:
                    f, a2 = L.mlp(gather(p["mlp"][di]), h), self._zero()
                return x + f, a2

            if remat and cache is None:
                x = L.remat(mixer, x)
                if x.shape[1] > 1:
                    x = actctx.shard(x, "btd_fsdp")
                x, a2 = L.remat(ffn, x)
            else:
                x = mixer(x)
                if x.shape[1] > 1:
                    x = actctx.shard(x, "btd_fsdp")
                x, a2 = ffn(x)
            if x.shape[1] > 1:
                x = actctx.shard(x, "btd_fsdp")
            if j != cfg.attn_index:
                mi += 1
            if gl_moe:
                ei += 1
            else:
                di += 1
            aux = aux + a2
        return x, aux

    # ------------------------------------------------------------------ #
    # heads
    # ------------------------------------------------------------------ #

    def _head(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.t()
        return self.lm_head

    def loss(self, batch: Dict, *, remat: bool = True) -> torch.Tensor:
        """Causal-LM cross entropy plus 0.01 × the MoE aux loss, under
        autograd.  batch: ``tokens`` (B, S) int, plus ``patch_embeds``
        for vlm (the loss covers the text positions only); numpy arrays
        or tensors, moved to the model's device.  Labels are the tokens
        shifted left, the last position masked.  The head is the padded
        one: the logsumexp runs over every padded-vocabulary column, as
        the reference's does."""
        dev = self.device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        pe = batch.get("patch_embeds")
        if pe is not None:
            pe = torch.as_tensor(pe, device=dev)
        if actctx.tp_ranks() is not None:
            return self._loss_tp(tokens, pe, remat)
        hidden, _, aux = self.forward(tokens, patch_embeds=pe, remat=remat)
        if pe is not None:
            hidden = hidden[:, pe.shape[1]:]
        labels, mask = shifted_labels(tokens)
        ce = L.chunked_ce_loss(hidden, self._head(), labels, mask)
        return ce + AUX_WEIGHT * aux

    # ------------------------------------------------------------------ #
    # tensor parallelism: one data row's TP ranks (``actctx.tp_ranks``)
    # ------------------------------------------------------------------ #

    def _loss_tp(self, tokens, pe, remat):
        """``loss`` over the running data row's TP ranks (the train step
        of a ``(data, model)`` mesh): ``_forward_tp``, then the
        vocabulary-parallel loss."""
        hiddens, aux = self._forward_tp(tokens, pe, None, None, remat)
        if pe is not None:
            hiddens = [h[:, pe.shape[1]:] for h in hiddens]
        labels, mask = shifted_labels(tokens)
        ce = head_loss_tp(hiddens, [m._head() for m in actctx.row_ranks()],
                          labels, mask, self.vocab_padded)
        return ce + AUX_WEIGHT * aux

    def _forward_tp(self, tokens, pe, cache, cache_pos, remat):
        """The layers over the running data row's ranks
        (``actctx.row_ranks``; this module is rank 0's): the
        vocabulary-parallel embedding, each layer's ranks (inside one
        recomputed region under ``remat``), the residual in the layout its
        pins ask for (``actctx.shard_ranks``: the sequence cut over
        ``model`` at ``btd_sp``, the features at ``btd_fsdp``; a decode
        step's (B, 1, d) replicated), the final norm.  ``cache``: the
        row's ``fsdp.RowCache`` (serving), filled or read at
        ``cache_pos``.  Returns (each rank's final hidden state, the MoE
        aux loss)."""
        cfg = self.cfg
        ranks, devices = actctx.row_ranks(), actctx.tp_devices()
        x = embed_tp([m.embed for m in ranks], tokens,
                     self.vocab_padded).to(self.dtype)
        if pe is not None:
            x = torch.cat([pe.to(x.device, self.dtype), x], dim=1)
        x = actctx.shard(x, "btd")
        b, s, _ = x.shape
        start = 0 if cache_pos is None else int(cache_pos)
        positions = (start + torch.arange(s, device=x.device)
                     )[None, :].expand(b, s)
        serve = dict(cache=cache, cache_pos=cache_pos)
        xs, axis = [x], None
        aux = self._zero()
        if cfg.family == "ssm":
            for l in range(cfg.num_layers):
                xs, axis = actctx.shard_ranks(
                    xs, axis, "btd_fsdp" if s > 1 else "btd")
                xs = self._tp_call(remat, partial(self._ssm_layer_tp,
                                                  **serve), l, axis, *xs)
        elif cfg.attn_period:
            for bi in range(len(self.layers)):
                xs, axis = actctx.shard_ranks(
                    xs, axis, "btd_fsdp" if s > 1 else "btd")
                *xs, a = self._tp_call(
                    remat, partial(self._hybrid_block_tp, **serve), bi,
                    positions, remat, axis, *xs)
                aux = aux + a
        else:
            for l in range(cfg.num_layers):
                xs, axis = actctx.shard_ranks(
                    xs, axis, "btd_sp" if s > 1 else "btd")
                *xs, a = self._tp_call(
                    remat, partial(self._attn_layer_tp, **serve), l,
                    positions, cfg.layer_window(l, s), axis, *xs)
                aux = aux + a
        hiddens = tp.enter(xs, axis, lambda h, j: L.rms_norm(
            h, ranks[j].final_norm, cfg.norm_eps), devices)
        return hiddens, aux

    @staticmethod
    def _tp_call(remat, fn, *args):
        out = L.remat(fn, *args) if remat else fn(*args)
        return list(out) if isinstance(out, tuple) else out

    def _ffn_tp(self, xs, axis, ps, norm):
        """The FFN sublayer over the row's ranks (MoE or MLP); returns
        (residual, aux)."""
        cfg = self.cfg
        if "router" in ps[0]:
            hs = tp.enter(xs, axis, norm, actctx.tp_devices())
            outs, aux, partial = MOE.moe_ffn_tp(
                ps, hs, top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor,
                chunk=cfg.moe_dispatch_chunk)
            return add_tp(xs, axis, outs, partial), aux

        return sublayer_tp(xs, axis, norm, mlp_run(cfg, ps)), self._zero()

    def _attn_layer_tp(self, l, positions, window, axis, *xs, cache=None,
                       cache_pos=None):
        cfg = self.cfg
        ps = [actctx.gather_params(m.layers[l], rank=j)
              for j, m in enumerate(actctx.row_ranks())]
        xs = attention_tp(
            cfg, list(xs), axis, [p["attn"] for p in ps],
            lambda h, j: L.rms_norm(h, ps[j]["ln1"], cfg.norm_eps),
            positions, window=window, rope=cfg.rope,
            cache=None if cache is None else cache.kv((), (l,)),
            cache_pos=cache_pos)
        xs, aux = self._ffn_tp(
            xs, axis, [p["ffn"] for p in ps],
            lambda h, j: L.rms_norm(h, ps[j]["ln2"], cfg.norm_eps))
        return (*xs, aux)

    def _mixer_ssm_tp(self, xs, axis, ps, norm, cache=None, path=(),
                      index=(), select=None):
        """The SSD mixer over the row's ranks: every rank's input first,
        then ``mamba2_block_tp`` (B/C are gathered between the ranks'
        projections and their scans), then ``tp.leave``.  ``cache``: the
        row's view (each rank's state of layer ``index`` under ``path``,
        updated in place), or the mesh's in a weight-stationary decode
        (the states updated where they lie, with the parameters
        ``select(module)`` of the data row that holds them)."""
        hs = tp.enter(xs, axis, norm, actctx.tp_devices())
        if isinstance(cache, fsdp.MeshCache):
            outs, partial, _ = SSM.mamba2_block_tp(
                ps, hs, self.cfg, holders=cache.states(path, index),
                select=select)
            return add_tp(xs, axis, outs, partial)
        states = None if cache is None else cache.states(path, index)
        outs, partial, news = SSM.mamba2_block_tp(ps, hs, self.cfg, states)
        for st, new in zip(states or (), news or ()):
            for k, v in new.items():
                st[k].copy_(v)
        return add_tp(xs, axis, outs, partial)

    def _ssm_layer_tp(self, l, axis, *xs, cache=None, cache_pos=None):
        cfg = self.cfg
        ps = [actctx.gather_params(m.layers[l], rank=j)
              for j, m in enumerate(actctx.row_ranks())]
        out = self._mixer_ssm_tp(
            list(xs), axis, [p["mamba"] for p in ps],
            lambda h, j: L.rms_norm(h, ps[j]["ln"], cfg.norm_eps), cache,
            (), (l,), lambda m: m.layers[l]["mamba"])
        return tuple(out)

    def _hybrid_block_tp(self, bi, positions, remat, axis, *xs, cache=None,
                         cache_pos=None):
        """``_hybrid_block`` over the row's ranks: each mixer and FFN
        gathers its ranks' weights inside the region it recomputes."""
        cfg = self.cfg
        ranks = actctx.row_ranks()
        blocks = [m.layers[bi] for m in ranks]
        aux = self._zero()
        xs = list(xs)
        mi = di = ei = 0
        for j in range(cfg.attn_period):
            gl_moe = cfg.is_moe_layer(j)  # period-aligned pattern

            def norm(key, j=j):
                return lambda h, r: L.rms_norm(h, blocks[r][key][j],
                                               cfg.norm_eps)

            def mixer(axis, *xs, j=j, mi=mi):
                if j == cfg.attn_index:
                    ps = [actctx.gather_params(b["attn"], rank=r)
                          for r, b in enumerate(blocks)]
                    return tuple(attention_tp(
                        cfg, list(xs), axis, ps, norm("ln1"), positions,
                        window=0, rope=cfg.rope,
                        cache=None if cache is None
                        else cache.kv(("attn",), (bi,)),
                        cache_pos=cache_pos))
                ps = [actctx.gather_params(b["mamba"][mi], rank=r)
                      for r, b in enumerate(blocks)]
                return tuple(self._mixer_ssm_tp(
                    list(xs), axis, ps, norm("ln1"), cache, ("mamba",),
                    (bi, mi), lambda m: m.layers[bi]["mamba"][mi]))

            def ffn(axis, *xs, gl_moe=gl_moe, di=di, ei=ei):
                ps = [actctx.gather_params(
                    b["moe"][ei] if gl_moe else b["mlp"][di], rank=r)
                    for r, b in enumerate(blocks)]
                out, a2 = self._ffn_tp(list(xs), axis, ps, norm("ln2"))
                return (*out, a2)

            xs = self._tp_call(remat, mixer, axis, *xs)
            if xs[0].shape[1] > 1:
                xs, axis = actctx.shard_ranks(xs, axis, "btd_fsdp")
            *xs, a2 = self._tp_call(remat, ffn, axis, *xs)
            if xs[0].shape[1] > 1:
                xs, axis = actctx.shard_ranks(xs, axis, "btd_fsdp")
            if j != cfg.attn_index:
                mi += 1
            if gl_moe:
                ei += 1
            else:
                di += 1
            aux = aux + a2
        return (*xs, aux)

    def logits(self, hidden_last):
        """(B, d) -> (B, vocab) fp32 logits: fp32 products of the hidden
        state and the head, as the reference's ``astype(f32)`` einsum.
        Over a data row's ranks (``hidden_last`` each rank's copy): the
        ranks' columns (``logits_tp``)."""
        if isinstance(hidden_last, (list, tuple)):
            return logits_tp(hidden_last,
                             [m._head() for m in actctx.row_ranks()],
                             self.vocab_padded, self.cfg.vocab_size)
        return L.mm_f32(hidden_last, self._head())[:, :self.cfg.vocab_size]

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #

    def init_cache(self, batch: int, max_len: int, device=None) -> Dict:
        """Zeros in the reference's layout on ``device`` (the model's by
        default; ``"meta"`` gives the structure alone)."""
        cfg, dt = self.cfg, self.dtype
        dev = self.device if device is None else torch.device(device)
        kv = lambda *lead: torch.zeros(
            lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim),
            dtype=dt, device=dev)
        if cfg.family == "ssm":
            st = SSM.init_mamba_state(cfg, batch, dt, dev)
            return {k: v[None].repeat((cfg.num_layers,) + (1,) * v.dim())
                    for k, v in st.items()}
        if cfg.attn_period:
            nb = cfg.num_layers // cfg.attn_period
            st = SSM.init_mamba_state(cfg, batch, dt, dev)
            return {"attn": {"k": kv(nb), "v": kv(nb)},
                    "mamba": {k: v[None, None].repeat(
                        (nb, cfg.attn_period - 1) + (1,) * v.dim())
                        for k, v in st.items()}}
        return {"k": kv(cfg.num_layers), "v": kv(cfg.num_layers)}

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, max_len: int,
                patch_embeds: Optional[torch.Tensor] = None, cache=None
                ) -> Tuple[Dict, torch.Tensor]:
        """Run the prompt, fill the cache, return (cache, last logits).
        No ``params`` argument: the weights live in the module.
        ``cache``: the empty cache to fill (a data row's ``fsdp.RowCache``
        on a mesh, whose logits are its ranks' columns); a new one by
        default."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], max_len)
        hidden, cache, _ = self.forward(tokens, patch_embeds=patch_embeds,
                                        cache=cache, cache_pos=0)
        return cache, self.logits(_last(hidden))

    @torch.inference_mode()
    def decode_step(self, cache: Dict, token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token for every sequence in the batch.  token: (B, 1); the
        cache is updated in place.  No ``params`` argument."""
        hidden, cache, _ = self.forward(token, cache=cache, cache_pos=pos)
        return self.logits(_last(hidden)), cache


def _last(hidden):
    """The last position's hidden state (each rank's, over a row)."""
    if isinstance(hidden, (list, tuple)):
        return [h[:, -1] for h in hidden]
    return hidden[:, -1]


__all__ = ["LM", "ParamTree", "register_tree", "check_device",
           "seeded_generator", "shifted_labels", "AUX_WEIGHT",
           "check_not_tp", "serves_rows", "embed_tp", "sublayer_tp",
           "add_tp", "attention_run", "attention_tp", "mlp_run",
           "head_loss_tp", "logits_tp"]
