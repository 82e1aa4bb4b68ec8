"""Masked-LM transformer encoder with HeteroFL width scaling.

Port of ``heterofl_tpu/models/transformer.py``: a learned positional
embedding over ``bptt`` positions, multi-head attention with separate
q/k/v/o projections each followed by a Scaler (unconditional here, unlike
the vision models' ``scale`` flag), post-norm encoder layers with the exact
GELU, a two-layer decoder head, and Bernoulli(``mask_rate``) corruption of
the input tokens to the extra ``<mask>`` id ``num_tokens`` in EVERY
forward, evaluation included.  The loss is the cross entropy over all
positions against the uncorrupted tokens.

Widths: the embedding axis is prefix-sliced (``emb``), q/k/v per head
(``qkv``: the first ``ceil(head_dim * rate)`` entries of each head), the
feed-forward axis prefix-sliced (``ffn``); the decoder's output and the
token embedding's rows are label-restricted at aggregation only.  The
attention temperature is ``sqrt(floor(k_emb / H))`` with ``k_emb`` the
active EMBEDDING dims, as the reference computes it.

Layout: linear kernels are ``[out, in]`` (``F.linear``), so the
reference's ``enc0.mha.q.w`` ``[E_in, E_out]`` with ``{0: emb, 1: qkv}`` is
``{1: emb, 0: qkv}`` here, and ``dec.l2.w`` is ``[V, E]`` with label axis
0.  The embedding tables ``embedding.tok.w`` ``[V + 1, E]`` and
``embedding.pos.w`` ``[bptt, E]`` keep the reference's layout
(:meth:`Transformer.jax_perms`).

Randomness: the corruption mask and each dropout site's keep mask are drawn
from the ``torch.Generator`` passed in, in forward order (the corruption
first, then dropout sites ``0``, ``1 + 3i``, ``2 + 3i``, ``3 + 3i``), or
handed in through ``draws`` (``{"corrupt": [N, S] bool, "keep": {site:
bool}}``), which is how tests give it the reference's ``jax.random``
draws.  Attention is the reference's plain chain (matmul, divide by the
temperature, softmax, matmul); no TPU kernel sits behind it.  Under
``compute_dtype`` (bfloat16) every linear layer casts its operands, and
the attention follows the reference (transformer.py:166-183): q, k and v
are cast after the head split, the scores come out of the bf16 product
and are cast to float32 before the temperature and the softmax, the
weights are cast back to bf16 and the output product is cast to float32.

:meth:`Transformer.forward_clients` is the training forward of a level's G
clients of one dense level model at once (the grouped engine): the
embedding as a per-client gather, every linear layer and the attention as
per-client batched products, each client's draws from its own generator
(in the order of :meth:`Transformer.forward`) at the level's widths.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..convert import Perms
from ..ops.layers import (cross_entropy, cross_entropy_clients, embed, gelu, linear,
                          linear_clients, masked_layer_norm, masked_logits, masked_logits_clients,
                          scaler)
from .base import FedModel, Holder
from .spec import Group, ParamSpec

Draws = Dict[str, Any]


class Transformer(FedModel):
    def __init__(self, num_tokens: int, embedding_size: int, num_heads: int, hidden_size: int,
                 num_layers: int, dropout: float, bptt: int, mask_rate: float, *,
                 mask: bool = True, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        E, H, F, V = embedding_size, num_heads, hidden_size, num_tokens
        self.num_tokens, self.num_heads, self.num_layers = V, H, num_layers
        self.dropout, self.bptt, self.mask_rate, self.mask = dropout, bptt, mask_rate, mask
        self.groups = {"emb": Group("emb", E), "qkv": Group("qkv", E, "per_head", H),
                       "ffn": Group("ffn", F), "vocab": Group("vocab", V, kind="full")}
        self.specs: Dict[str, ParamSpec] = {}
        #: names of the linear layers (their ``.w`` are ``[out, in]`` kernels)
        self.linears = []

        def norm(name: str) -> Holder:
            self.specs[f"{name}.g"] = self.specs[f"{name}.b"] = ParamSpec({0: "emb"})
            return Holder(g=(E,), b=(E,))

        def lin(name: str, out: int, inp: int, out_g: Optional[str], in_g: str,
                label: bool = False) -> Holder:
            self.linears.append(name)
            og = {} if out_g is None else {0: out_g}
            la = 0 if label else None
            self.specs[f"{name}.w"] = ParamSpec({**og, 1: in_g}, label_axis=la)
            self.specs[f"{name}.b"] = ParamSpec(og, label_axis=la)
            return Holder(w=(out, inp), b=(out,))

        emb = torch.nn.Module()
        emb.tok = Holder(w=(V + 1, E))
        emb.pos = Holder(w=(bptt, E))
        emb.norm = norm("embedding.norm")
        self.specs["embedding.tok.w"] = ParamSpec({1: "emb"}, label_axis=0)
        self.specs["embedding.pos.w"] = ParamSpec({1: "emb"})
        self.embedding = emb
        for i in range(num_layers):
            p = f"enc{i}"
            layer, mha, ff = torch.nn.Module(), torch.nn.Module(), torch.nn.Module()
            for h in ("q", "k", "v"):
                mha.add_module(h, lin(f"{p}.mha.{h}", E, E, "qkv", "emb"))
            mha.o = lin(f"{p}.mha.o", E, E, "emb", "qkv")
            ff.l1 = lin(f"{p}.ff.l1", F, E, "ffn", "emb")
            ff.l2 = lin(f"{p}.ff.l2", E, F, "emb", "ffn")
            layer.mha, layer.ff = mha, ff
            layer.norm1, layer.norm2 = norm(f"{p}.norm1"), norm(f"{p}.norm2")
            self.add_module(p, layer)
        dec = torch.nn.Module()
        dec.l1 = lin("dec.l1", E, E, "emb", "emb")
        dec.norm = norm("dec.norm")
        dec.l2 = lin("dec.l2", V, E, None, "emb", label=True)
        self.dec = dec
        self._emb_masks: Dict[Tuple[float, torch.device], torch.Tensor] = {}
        self.meta = {"kind": "transformer", "num_tokens": V, "embedding_size": E,
                     "num_heads": H, "hidden_size": F, "num_layers": num_layers, "bptt": bptt}

    def jax_perms(self) -> Perms:
        """Only the linear kernels are transposed; the embedding tables are
        ``[rows, E]`` in both packages."""
        return {f"{n}.w": (1, 0) for n in self.linears}

    def init_(self, generator: torch.Generator) -> "Transformer":
        """Fill every parameter from ``generator`` (sorted-name order), with
        the reference's distributions (heterofl_tpu/models/transformer.py
        init): N(0, 1) embedding tables, N(0, 0.02) feed-forward kernels,
        uniform(+-1/sqrt(E)) attention and decoder kernels, zero biases,
        ones/zeros norm scale and shift."""
        E = self.groups["emb"].size
        with torch.no_grad():
            for name, p in sorted(self.named_parameters()):
                if name.startswith("embedding.") and name.endswith(".w"):
                    p.copy_(torch.empty(p.shape).normal_(0.0, 1.0, generator=generator))
                elif ".ff." in name and name.endswith(".w"):
                    p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=generator))
                elif name.endswith(".w"):
                    bound = 1.0 / math.sqrt(E)
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
                else:
                    p.fill_(1.0 if name.endswith(".g") else 0.0)
        return self

    def _emb_mask(self, width_rate: float, dev: torch.device) -> torch.Tensor:
        """The embedding axis's activity mask on ``dev``, made once per
        width (a copy to the card inside a step would wait for it)."""
        key = (float(width_rate), dev)
        if key not in self._emb_masks:
            self._emb_masks[key] = self.groups["emb"].mask(width_rate).to(dev)
        return self._emb_masks[key]

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, temp: float
                   ) -> torch.Tensor:
        """``softmax(q k^T / temp) v`` over the last two axes; under
        ``compute_dtype`` the two products take bf16 operands and their
        results go back to float32, the softmax in float32."""
        cd = self.compute_dtype
        if cd is None:
            return torch.matmul(torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / temp,
                                              dim=-1), v)
        q, k, v = q.to(cd), k.to(cd), v.to(cd)
        scores = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32) / temp
        attn = torch.softmax(scores, dim=-1).to(cd)
        return torch.matmul(attn, v).to(torch.float32)

    def forward(self, label: torch.Tensor, *, params=None, width_rate: float = 1.0,
                scaler_rate: float = 1.0, label_mask=None, sample_weight=None,
                train: bool = True, gen: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token windows ``label [N, S]`` -> ``(scores [N, S, V], weighted
        mean loss)``; ``sample_weight`` are the position weights ``[N, S]``.
        ``train`` turns on dropout and the Scaler; the corruption runs
        either way.  Draws come from ``draws`` where given, else from
        ``gen``."""
        P = params if params is not None else self.params()
        N, S = label.shape
        H, dev = self.num_heads, label.device
        E = self.groups["emb"].size
        hd = E // H
        emb_mask = self._emb_mask(width_rate, dev)
        k_emb = float(self.groups["emb"].active_count(width_rate))
        temp = math.sqrt(math.floor(k_emb / H))
        draws = draws or {}
        keeps = draws.get("keep", {})

        def rand_mask(shape, p_true: float) -> torch.Tensor:
            return torch.rand(shape, generator=gen, device=dev) < p_true

        def dropout(x: torch.Tensor, site: int) -> torch.Tensor:
            if not train or self.dropout == 0.0:
                return x
            keep = keeps.get(site)
            keep = rand_mask(x.shape, 1.0 - self.dropout) if keep is None else keep.to(dev)
            return torch.where(keep, x / (1.0 - self.dropout), 0.0)

        def sc(x: torch.Tensor) -> torch.Tensor:
            return scaler(x, scaler_rate, train)

        def ln(site: str, x: torch.Tensor) -> torch.Tensor:
            return masked_layer_norm(x, P[f"{site}.g"], P[f"{site}.b"], emb_mask, k_emb)

        def lin(name: str, x: torch.Tensor) -> torch.Tensor:
            return linear(x, P[f"{name}.w"], P[f"{name}.b"], self.compute_dtype)

        corrupt = draws.get("corrupt")
        corrupt = rand_mask((N, S), self.mask_rate) if corrupt is None else corrupt.to(dev)
        src = torch.where(corrupt, self.num_tokens, label)
        x = sc(embed(P["embedding.tok.w"], src)) + sc(P["embedding.pos.w"][:S])[None]
        x = dropout(ln("embedding.norm", x), 0)

        def heads(t: torch.Tensor) -> torch.Tensor:  # [N, S, E] -> [N, H, S, hd]
            return t.reshape(N, S, H, hd).transpose(1, 2)

        for i in range(self.num_layers):
            p = f"enc{i}"
            q, k, v = (heads(sc(lin(f"{p}.mha.{h}", x))) for h in ("q", "k", "v"))
            o = self._attention(q, k, v, temp).transpose(1, 2).reshape(N, S, E)
            o = sc(lin(f"{p}.mha.o", o))
            x = ln(f"{p}.norm1", x + dropout(o, 1 + 3 * i))
            h = dropout(gelu(sc(lin(f"{p}.ff.l1", x))), 2 + 3 * i)
            h = sc(lin(f"{p}.ff.l2", h))
            x = ln(f"{p}.norm2", x + dropout(h, 3 + 3 * i))
        d = ln("dec.norm", gelu(sc(lin("dec.l1", x))))
        out = masked_logits(lin("dec.l2", d), label_mask, self.mask)
        return out, cross_entropy(out, label, sample_weight)

    def forward_clients(self, label: torch.Tensor, G: int, *, params, scaler_rate: float = 1.0,
                        label_mask=None, sample_weight=None,
                        gens: Optional[List[torch.Generator]] = None,
                        draws: Optional[List[Draws]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward of G clients at once at full width of this
        (dense level) model: ``label [G, N, S]``, ``sample_weight [G, N,
        S]``, ``label_mask [G, V]``, ``params`` leaves ``[G, *shape]``;
        client g's draws come from ``draws[g]`` where given, else from
        ``gens[g]`` -> ``(scores [G, N, S, V], per-client mean loss [G])``."""
        P = params
        _, N, S = label.shape
        H, dev = self.num_heads, label.device
        E = self.groups["emb"].size
        hd = E // H
        emb_mask = self._emb_mask(1.0, dev)
        temp = math.sqrt(math.floor(float(E) / H))
        keeps = [d.get("keep", {}) for d in draws] if draws is not None else None

        def rand_mask(shape, p_true: float) -> torch.Tensor:
            return torch.stack([torch.rand(shape, generator=gen, device=dev) < p_true
                                for gen in gens])

        def dropout(x: torch.Tensor, site: int) -> torch.Tensor:
            if self.dropout == 0.0:
                return x
            keep = rand_mask(x.shape[1:], 1.0 - self.dropout) if keeps is None else \
                torch.stack([k[site] for k in keeps]).to(dev)
            return torch.where(keep, x / (1.0 - self.dropout), 0.0)

        def sc(x: torch.Tensor) -> torch.Tensor:
            return scaler(x, scaler_rate)

        def vec(name: str) -> torch.Tensor:  # [G, E] -> [G, 1, 1, E]
            return P[name][:, None, None, :]

        def ln(site: str, x: torch.Tensor) -> torch.Tensor:
            return masked_layer_norm(x, vec(f"{site}.g"), vec(f"{site}.b"), emb_mask, float(E))

        def lin(name: str, x: torch.Tensor) -> torch.Tensor:
            return linear_clients(x, P[f"{name}.w"], P[f"{name}.b"], self.compute_dtype)

        corrupt = rand_mask((N, S), self.mask_rate) if draws is None else \
            torch.stack([d["corrupt"] for d in draws]).to(dev)
        src = torch.where(corrupt, self.num_tokens, label)
        tok = P["embedding.tok.w"][torch.arange(G, device=dev)[:, None, None], src]
        x = sc(tok) + sc(P["embedding.pos.w"][:, :S])[:, None]
        x = dropout(ln("embedding.norm", x), 0)

        def heads(t: torch.Tensor) -> torch.Tensor:  # [G, N, S, E] -> [G, N, H, S, hd]
            return t.reshape(G, N, S, H, hd).transpose(2, 3)

        for i in range(self.num_layers):
            p = f"enc{i}"
            q, k, v = (heads(sc(lin(f"{p}.mha.{h}", x))) for h in ("q", "k", "v"))
            o = self._attention(q, k, v, temp).transpose(2, 3).reshape(G, N, S, E)
            o = sc(lin(f"{p}.mha.o", o))
            x = ln(f"{p}.norm1", x + dropout(o, 1 + 3 * i))
            h = dropout(gelu(sc(lin(f"{p}.ff.l1", x))), 2 + 3 * i)
            h = sc(lin(f"{p}.ff.l2", h))
            x = ln(f"{p}.norm2", x + dropout(h, 3 + 3 * i))
        d = ln("dec.norm", gelu(sc(lin("dec.l1", x))))
        out = masked_logits_clients(lin("dec.l2", d), label_mask, self.mask)
        return out, cross_entropy_clients(out, label, sample_weight)
