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

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from .config import ModelConfig
from ..distributed import actctx

f32 = torch.float32
AUX_WEIGHT = 0.01          # the MoE aux loss's weight in ``LM.loss``


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
        of its sublayers) in the backward pass."""
        cfg = self.cfg
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
        hidden, _, aux = self.forward(tokens, patch_embeds=pe, remat=remat)
        if pe is not None:
            hidden = hidden[:, pe.shape[1]:]
        labels, mask = shifted_labels(tokens)
        ce = L.chunked_ce_loss(hidden, self._head(), labels, mask)
        return ce + AUX_WEIGHT * aux

    def logits(self, hidden_last: torch.Tensor) -> torch.Tensor:
        """(B, d) -> (B, vocab) fp32 logits: fp32 products of the hidden
        state and the head, as the reference's ``astype(f32)`` einsum."""
        return L.mm_f32(hidden_last, self._head())[:, :self.cfg.vocab_size]

    # ------------------------------------------------------------------ #
    # serving
    # ------------------------------------------------------------------ #

    def init_cache(self, batch: int, max_len: int) -> Dict:
        cfg, dt, dev = self.cfg, self.dtype, self.device
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
                patch_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[Dict, torch.Tensor]:
        """Run the prompt, fill the cache, return (cache, last logits).
        No ``params`` argument: the weights live in the module."""
        cache = self.init_cache(tokens.shape[0], max_len)
        hidden, cache, _ = self.forward(tokens, patch_embeds=patch_embeds,
                                        cache=cache, cache_pos=0)
        return cache, self.logits(hidden[:, -1])

    @torch.inference_mode()
    def decode_step(self, cache: Dict, token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token for every sequence in the batch.  token: (B, 1); the
        cache is updated in place.  No ``params`` argument."""
        hidden, cache, _ = self.forward(token, cache=cache, cache_pos=pos)
        return self.logits(hidden[:, -1]), cache


__all__ = ["LM", "ParamTree", "register_tree", "check_device",
           "seeded_generator", "shifted_labels", "AUX_WEIGHT"]
