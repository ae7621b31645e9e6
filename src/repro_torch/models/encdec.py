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
from ..distributed import actctx
from .transformer import (check_device, register_tree, seeded_generator,
                          shifted_labels)

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
        """frames: (B, S_enc, d_model) stub embeddings -> encoder states."""
        cfg = self.cfg
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
        ks, vs = [], []
        for p in self.dec_layers:
            ks.append(L.contract(enc_out, p["cross"]["wk"], False
                                 ).to(self.dtype))
            vs.append(L.contract(enc_out, p["cross"]["wv"], False
                                 ).to(self.dtype))
        return torch.stack(ks), torch.stack(vs)

    def decode(self, tokens: torch.Tensor, cross_kv,
               cache: Optional[Dict] = None,
               cache_pos: Optional[int] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Decoder hidden states (B, S, d) and the self-attention cache
        (updated in place)."""
        cfg = self.cfg
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
        enc_out = self.encode(torch.as_tensor(batch["frames"], device=dev))
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        hidden, _ = self.decode(tokens, self._cross_kv(enc_out))
        labels, mask = shifted_labels(tokens)
        return L.chunked_ce_loss(hidden, self.embed.t(), labels, mask)

    def logits(self, hidden_last: torch.Tensor) -> torch.Tensor:
        """(B, d) -> (B, vocab) fp32 logits against the tied embedding."""
        return L.mm_f32(hidden_last, self.embed.t())[:, :self.cfg.vocab_size]

    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, max_dec: int) -> Dict:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_dec, cfg.num_kv_heads,
                 cfg.head_dim)
        z = lambda: torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {"k": z(), "v": z()}

    @torch.inference_mode()
    def prefill(self, frames: torch.Tensor, tokens: torch.Tensor,
                max_dec: int) -> Tuple[Dict, torch.Tensor]:
        """Encode, cache the cross K/V, run the prompt: (cache, logits).
        No ``params`` argument: the weights live in the module."""
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
        hidden, self_cache = self.decode(
            token, (cache["cross"]["k"], cache["cross"]["v"]),
            cache=cache["self"], cache_pos=pos)
        return self.logits(hidden[:, -1]), {"self": self_cache,
                                            "cross": cache["cross"]}


__all__ = ["EncDec", "sinusoidal"]
