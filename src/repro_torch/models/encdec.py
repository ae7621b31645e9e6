"""Whisper-style encoder-decoder (audio family) — port of
``src/repro/models/encdec.py`` as an ``nn.Module``.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  Sinusoidal positions
on both stacks.

Encoder: non-causal self-attention, GELU (tanh form) MLP, LayerNorm.
Decoder: causal self-attention + cross-attention over encoder output.
Serving: ``encode`` runs once, its per-layer cross K/V are cached; decode
steps touch only the decoder self-cache plus the fixed cross cache.

The weights live in the module (``enc_layers`` and ``dec_layers`` are
``nn.ModuleList``s, one entry per layer), so no method takes the
reference's ``params`` argument.  ``prefill`` and ``decode_step`` run
under ``torch.inference_mode()``; ``encode``, ``decode`` and
``_cross_kv`` run under the caller's grad mode, so ``loss`` trains
through them (no remat by default, as in the reference).  The
self-attention cache is updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import layers as L
from .config import ModelConfig
from ..distributed import actctx, tp
from .transformer import (_last, attention_tp, check_device, check_not_tp,
                          embed_tp, head_loss_tp, logits_tp, mlp_run,
                          register_tree, seeded_generator, serves_rows,
                          shifted_labels, sublayer_tp)

f32 = torch.float32


def sinusoidal(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    half = d_model // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    ang = positions.to(f32)[..., None] * torch.tensor(
        freqs, dtype=f32, device=positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDec(nn.Module):
    """``EncDec(cfg, device="cuda", seed=0)``: random weights with the
    reference's distributions from a seeded ``torch.Generator`` on
    ``device``.  Raises without a card unless ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, device="cuda", seed: int = 0):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError("EncDec needs an encoder-decoder config")
        dev = check_device(device)
        self.cfg = cfg
        self.dtype = L._dtype(cfg.dtype)
        self.vocab_padded = -(-cfg.vocab_size // 256) * 256
        with torch.no_grad():
            register_tree(self, self._init_tree(seeded_generator(dev, seed)))

    def _init_tree(self, gen: torch.Generator) -> Dict:
        cfg, dt = self.cfg, self.dtype

        def attn_p():
            return L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.head_dim, False,
                                    dt)

        def mlp_p():
            return L.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dt)

        def ln():
            z = lambda: torch.zeros(cfg.d_model, dtype=dt, device=gen.device)
            return {"scale": z(), "bias": z()}

        enc = [{"attn": attn_p(), "mlp": mlp_p(), "ln1": ln(), "ln2": ln()}
               for _ in range(cfg.num_encoder_layers)]
        dec = [{"self": attn_p(), "cross": attn_p(), "mlp": mlp_p(),
                "ln1": ln(), "ln2": ln(), "ln3": ln()}
               for _ in range(cfg.num_layers)]
        return {"embed": L.init_embedding(gen, self.vocab_padded,
                                          cfg.d_model, dt),
                "enc_layers": enc, "dec_layers": dec,
                "enc_norm": ln(), "dec_norm": ln()}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _ln(self, x, p):
        return L.layer_norm(x, p["scale"], p["bias"], self.cfg.norm_eps)

    def _positions(self, b: int, s: int, start: int = 0) -> torch.Tensor:
        return (start + torch.arange(s, device=self.device))[None, :].expand(
            b, s)

    # ------------------------------------------------------------------ #
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, S_enc, d_model) stub embeddings -> encoder states
        (over a data row's ranks: ``_encode_tp``, on rank 0's device)."""
        cfg = self.cfg
        if actctx.tp_ranks() is not None:
            return self._encode_tp(frames.to(self.device))
        check_not_tp(self)
        b, s, _ = frames.shape
        positions = self._positions(b, s)
        x = (frames.to(self.device, self.dtype)
             + sinusoidal(positions, cfg.d_model).to(self.dtype))
        x = actctx.shard(x, "btd")
        for p in self.enc_layers:
            x = actctx.shard(x, "btd_sp")
            p = actctx.gather_params(p)
            h = self._ln(x, p["ln1"])
            a, _ = L.attention(p["attn"], h, positions=positions, window=0,
                               num_kv_heads=cfg.num_kv_heads, rope=False,
                               rope_theta=cfg.rope_theta,
                               norm_eps=cfg.norm_eps, causal=False)
            x = x + a
            h = self._ln(x, p["ln2"])
            x = x + L.mlp(p["mlp"], h)
        return self._ln(x, self.enc_norm)

    def _cross_kv(self, enc_out: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-decoder-layer cross K/V, stacked (L, B, S_enc, G, hd)."""
        ks, vs = zip(*(self._cross_kv_layer(enc_out, l)
                       for l in range(len(self.dec_layers))))
        return torch.stack(ks), torch.stack(vs)

    def _cross_kv_layer(self, enc_out: torch.Tensor, l: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decoder layer ``l``'s cross K/V (B, S_enc, G, hd)."""
        p = self.dec_layers[l]
        # the reference contracts the sharded leaves in place (GSPMD adds
        # the collective); the port gathers them first
        p = actctx.gather_params({"wk": p["cross"]["wk"],
                                  "wv": p["cross"]["wv"]})
        return (L.contract(enc_out, p["wk"], False).to(self.dtype),
                L.contract(enc_out, p["wv"], False).to(self.dtype))

    def decode(self, tokens: torch.Tensor, cross_kv,
               cache: Optional[Dict] = None,
               cache_pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Decoder hidden states (B, S, d) and the self-attention cache
        (updated in place)."""
        cfg = self.cfg
        check_not_tp(self)
        b, s = tokens.shape
        positions = self._positions(b, s, 0 if cache_pos is None
                                    else int(cache_pos))
        x = (self.embed[tokens.to(self.device)].to(self.dtype)
             + sinusoidal(positions, cfg.d_model).to(self.dtype))
        x = actctx.shard(x, "btd")
        ck, cv = cross_kv
        for l, p in enumerate(self.dec_layers):
            x = actctx.shard(x, "btd_sp" if x.shape[1] > 1 else "btd")
            p = actctx.gather_params(p)
            c = None if cache is None else {"k": cache["k"][l],
                                            "v": cache["v"][l]}
            h = self._ln(x, p["ln1"])
            a, _ = L.attention(p["self"], h, positions=positions, window=0,
                               num_kv_heads=cfg.num_kv_heads, rope=False,
                               rope_theta=cfg.rope_theta,
                               norm_eps=cfg.norm_eps, cache=c,
                               cache_pos=cache_pos)
            x = x + a
            h = self._ln(x, p["ln2"])
            a, _ = L.attention(p["cross"], h, positions=positions, window=0,
                               num_kv_heads=cfg.num_kv_heads, rope=False,
                               rope_theta=cfg.rope_theta,
                               norm_eps=cfg.norm_eps,
                               kv_override=(ck[l], cv[l]), causal=False)
            x = x + a
            h = self._ln(x, p["ln3"])
            x = x + L.mlp(p["mlp"], h)
        return self._ln(x, self.dec_norm), cache

    def loss(self, batch: Dict, *, remat: bool = False) -> torch.Tensor:
        """Cross entropy of the next decoder token.  batch: ``frames``
        (B, S_enc, d), ``tokens`` (B, S_dec); numpy arrays or tensors.
        The head is the padded ``embed.T``.  ``remat`` is accepted and
        unused, as in the reference."""
        dev = self.device
        if actctx.tp_ranks() is not None:
            return self._loss_tp(
                torch.as_tensor(batch["frames"], device=dev),
                torch.as_tensor(batch["tokens"], device=dev))
        enc_out = self.encode(torch.as_tensor(batch["frames"], device=dev))
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, _ = self.decode(tokens, self._cross_kv(enc_out))
        labels, mask = shifted_labels(tokens)
        return L.chunked_ce_loss(hidden, self.embed.t(), labels, mask)

    # ------------------------------------------------------------------ #
    def _loss_tp(self, frames: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
        """``loss`` over the running data row's TP ranks (the train step
        of a ``(data, model)`` mesh): ``_encode_tp``, ``_decode_tp`` and
        the vocabulary-parallel loss."""
        hiddens = self._decode_tp(tokens, self._encode_tp(frames))
        labels, mask = shifted_labels(tokens)
        return head_loss_tp(hiddens,
                            [m.embed.t() for m in actctx.row_ranks()],
                            labels, mask, self.vocab_padded)

    def _ln_tp(self, key):
        ranks = actctx.row_ranks()
        return lambda h, j: self._ln(h, getattr(ranks[j], key))

    def _encode_tp(self, frames: torch.Tensor) -> torch.Tensor:
        """``encode`` over the running data row's ranks (this module is
        rank 0's): the layers' ranks, the residual cut along the sequence
        where its pin asks (``btd_sp``); the output joined and normed
        once, on rank 0's device."""
        cfg = self.cfg
        ranks = actctx.row_ranks()
        b, s, _ = frames.shape
        positions = self._positions(b, s)
        x = (frames.to(self.dtype)
             + sinusoidal(positions, cfg.d_model).to(self.dtype))
        xs, axis = [actctx.shard(x, "btd")], None
        for l in range(cfg.num_encoder_layers):
            xs, axis = actctx.shard_ranks(xs, axis, "btd_sp")
            ps = [actctx.gather_params(m.enc_layers[l], rank=j)
                  for j, m in enumerate(ranks)]
            xs = attention_tp(cfg, xs, axis, [p["attn"] for p in ps],
                              lambda h, j: self._ln(h, ps[j]["ln1"]),
                              positions, window=0, rope=False, causal=False)
            xs = sublayer_tp(xs, axis, lambda h, j: self._ln(h, ps[j]["ln2"]),
                             mlp_run(cfg, [p["mlp"] for p in ps]))
        return self._ln(xs[0] if axis is None else tp.gather_seq(xs, axis),
                        self.enc_norm)

    def _decode_tp(self, tokens: torch.Tensor, enc=None, cache=None,
                   cache_pos=None):
        """``decode`` over the running data row's ranks: the
        vocabulary-parallel embedding, the layers' ranks (the residual cut
        along the sequence where its pin asks), the final norm on every
        rank.  ``enc`` (the encoder's output, on rank 0's device): each
        layer's cross K/V, computed once a row and handed to the ranks,
        and written into ``cache`` (the row's ``fsdp.RowCache``, its
        ``cross`` pair) where one is filled; without ``enc`` the
        cross-attention reads that cache.  Returns each rank's hidden
        state."""
        cfg = self.cfg
        ranks, devices = actctx.row_ranks(), actctx.tp_devices()
        b, s = tokens.shape
        positions = self._positions(b, s, 0 if cache_pos is None
                                    else int(cache_pos))
        x = (embed_tp([m.embed for m in ranks], tokens, self.vocab_padded
                      ).to(self.dtype)
             + sinusoidal(positions, cfg.d_model).to(self.dtype))
        xs, axis = [actctx.shard(x, "btd")], None
        for l in range(cfg.num_layers):
            xs, axis = actctx.shard_ranks(xs, axis,
                                          "btd_sp" if s > 1 else "btd")
            ps = [actctx.gather_params(m.dec_layers[l], rank=j)
                  for j, m in enumerate(ranks)]

            def ln(key):
                return lambda h, j: self._ln(h, ps[j][key])

            def attn(key, causal, **kw):
                return attention_tp(cfg, xs, axis, [p[key] for p in ps],
                                    ln("ln1" if key == "self" else "ln2"),
                                    positions, window=0, rope=False,
                                    causal=causal, **kw)
            xs = attn("self", True, cache=None if cache is None
                      else cache.kv(("self",), (l,)), cache_pos=cache_pos)
            if enc is None:
                xs = attn("cross", False, cache=cache.kv(("cross",), (l,)),
                          write=False)
            else:
                ck, cv = self._cross_kv_layer(enc, l)
                if cache is not None:
                    L.write_kv(cache.kv(("cross",), (l,)), ck, cv, 0)
                xs = attn("cross", False, kv=list(zip(
                    tp.copy_to_ranks(ck, devices),
                    tp.copy_to_ranks(cv, devices))))
            xs = sublayer_tp(xs, axis, ln("ln3"),
                             mlp_run(cfg, [p["mlp"] for p in ps]))
        return tp.enter(xs, axis, self._ln_tp("dec_norm"), devices)

    def logits(self, hidden_last):
        """(B, d) -> (B, vocab) fp32 logits against the tied embedding;
        over a data row's ranks, the ranks' columns (``logits_tp``)."""
        if isinstance(hidden_last, (list, tuple)):
            return logits_tp(hidden_last,
                             [m.embed.t() for m in actctx.row_ranks()],
                             self.vocab_padded, self.cfg.vocab_size)
        return L.mm_f32(hidden_last, self.embed.t())[:, :self.cfg.vocab_size]

    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, max_dec: int, device=None) -> Dict:
        """The self-attention cache's zeros on ``device`` (the model's by
        default; ``"meta"`` gives the structure alone)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_dec, cfg.num_kv_heads,
                 cfg.head_dim)
        dev = self.device if device is None else torch.device(device)
        z = lambda: torch.zeros(shape, dtype=self.dtype, device=dev)
        return {"k": z(), "v": z()}

    def cache_structure(self, batch: int, max_dec: int, enc_len: int
                        ) -> Dict:
        """The serving cache's structure (``meta`` tensors): the
        self-attention cache and the cross K/V of ``enc_len`` frames."""
        cfg = self.cfg
        cross = torch.empty((cfg.num_layers, batch, enc_len,
                             cfg.num_kv_heads, cfg.head_dim),
                            dtype=self.dtype, device="meta")
        return {"self": self.init_cache(batch, max_dec, "meta"),
                "cross": {"k": cross, "v": cross}}

    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                max_dec: int, cache=None) -> Tuple[Dict, torch.Tensor]:
        """Encode, cache the cross K/V, run the prompt: (cache, logits).
        No ``params`` argument: the weights live in the module.
        ``cache``: on a mesh, the data row's ``fsdp.RowCache`` to fill
        (``cache_structure``'s layout; the logits are the ranks'
        columns)."""
        if serves_rows(cache):
            hiddens = self._decode_tp(tokens.to(self.device), self.encode(
                frames), cache, 0)
            return cache, self.logits(_last(hiddens))
        cross_kv = self._cross_kv(self.encode(frames))
        cache = self.init_cache(tokens.shape[0], max_dec)
        hidden, cache = self.decode(tokens, cross_kv, cache=cache,
                                    cache_pos=0)
        return ({"self": cache,
                 "cross": {"k": cross_kv[0], "v": cross_kv[1]}},
                self.logits(hidden[:, -1]))

    @torch.inference_mode()
    def decode_step(self, cache: Dict, token: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Dict]:
        """One token per sequence.  No ``params`` argument."""
        if serves_rows(cache):
            hiddens = self._decode_tp(token.to(self.device), cache=cache,
                                      cache_pos=pos)
            return self.logits(_last(hiddens)), cache
        hidden, self_cache = self.decode(
            token, (cache["cross"]["k"], cache["cross"]["v"]),
            cache=cache["self"], cache_pos=pos)
        return self.logits(hidden[:, -1]), {"self": self_cache,
                                            "cross": cache["cross"]}


__all__ = ["EncDec", "sinusoidal"]
