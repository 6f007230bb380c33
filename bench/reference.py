"""The plain reference: a decoder's forward pass in float32 with TF32 off,
written from the published architectures (a dense GQA decoder with
qk-norm, as Qwen3; MLA with a dense first layer and routed plus shared
SwiGLU experts, as DeepSeek-V2), in plain PyTorch.  It imports nothing of
the program and takes nothing the program made: the weights are the
benchmark's own inputs (``bench.weights``), read by name.

LeoAM's decode attends, at each decode position and attention layer, to
the rows of the chunks its evaluation selected plus the new token.  The
reference cannot derive those selections whole (the forced hot chunks
depend on the program's history), so it takes them as recorded from the
program and attends, in float32, over exactly those rows; everything
else -- every projection, norm, rotation, routing, expert, the softmax
and the logits -- it works out again from the prompt and the served
tokens.  The evaluation is judged apart (:class:`Evaluation`): at every
decode position and layer the reference scores each chunk by the box
bound over its own float32 rows and takes the configured rate's top
chunks, and the program's selection has to hold them.

``precision="fp8"`` is the control: the same computation with both
operands of every matrix product rounded to float8 e4m3 under one scale a
tensor (the weights' scale per weight tensor, the activations' per
product), the nearest precision below the model's bfloat16.
``precision="bf16"`` rounds them to bfloat16 instead: a witness of what
the configuration's own precision costs, never a reading of the program.

Departures from the published models, which the program makes too and the
configuration files list: RoPE pairs the first and second halves of each
head (NeoX), DeepSeek's YaRN scaling is not applied, and the routed
weights are renormalized over the top-k.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Math:
    """Matrix products at the chosen precision."""

    def __init__(self, precision: str):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"
        self.bf16 = precision == "bf16"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to e4m3 under one scale (fp8), to bfloat16 (bf16:
        the configuration's own precision, a witness), else itself."""
        if self.bf16:
            return x.to(torch.bfloat16).float()
        if not self.fp8:
            return x
        amax = x.abs().max().clamp_min(1e-30)
        s = amax / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(w)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, dim); first half paired with the second."""
    dim = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=x.device) / dim))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _is_moe(m: Dict, layer: int) -> bool:
    return bool(m.get("n_routed_experts")) and \
        layer >= m.get("first_k_dense_replace", 0)


class Sample:
    """One request to judge: its prompt, the tokens the program served
    (the first from the prefill), the chunk selections the program
    attended at each decode position (``sels[p][layer]`` for the decode
    row at position ``p``) and, of those, the chunks the device pool held
    as int4 transit payload with the number of their rows it covered
    (``int4[p][layer] = {chunk: rows}``)."""

    def __init__(self, prompt: np.ndarray, served: Sequence[int],
                 sels: Dict[int, List[Sequence[int]]], chunk: int,
                 int4: Optional[Dict[int, Dict[int, Dict[int, int]]]] = None):
        self.prompt = np.asarray(prompt, np.int64)
        self.served = [int(t) for t in served]
        self.sels = sels
        self.chunk = int(chunk)
        self.int4 = int4 or {}

    @property
    def tokens(self) -> np.ndarray:
        """The rows the reference runs: the prompt, then every served
        token but the last (which nothing attends)."""
        return np.concatenate([self.prompt,
                               np.asarray(self.served[:-1], np.int64)])

    @property
    def rows(self) -> range:
        """The rows whose logits chose the served tokens."""
        S = len(self.prompt)
        return range(S - 1, S - 1 + len(self.served))


def int4_round_trip(x: torch.Tensor) -> torch.Tensor:
    """The transit codec on one chunk's rows (n, channels...): one scale a
    channel, the largest magnitude over the rows over 7, values rounded
    half to even and clipped to [-7, 7]."""
    amax = x.abs().amax(dim=0, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    return torch.clamp(torch.round(x / scale), -7, 7) * scale


class Evaluation:
    """The chunk evaluation judged against the reference's own.  At each
    decode position ``p`` and layer, every chunk of the rows before ``p``
    is scored by the bound the configuration's evaluation ranks by: per
    key head, the query's positive part against the chunk's per-channel
    maximum plus its negative part against the minimum, summed over the
    heads sharing that key head, then the largest over key heads.  The
    reference's top chunks are those, in score order, that first cover
    the layer's rate of the ``p`` rows (at least one chunk).  The number
    compared is the share of them the program's selection left out."""

    def __init__(self, rates: Sequence[float], block: int = 64):
        self.rates = list(rates)
        self.block = block
        self.missed = 0
        self.wanted = 0

    def miss_share(self) -> float:
        return self.missed / self.wanted if self.wanted else 0.0

    def add(self, sample: "Sample", layer: int, q: torch.Tensor,
            k: torch.Tensor) -> None:
        """q (T, Hkv, G, d) scoring queries, k (T, Hkv, d) exact rows."""
        S, chunk, T = len(sample.prompt), sample.chunk, k.shape[0]
        if T <= S:
            return
        dev = k.device
        nc = -(-T // chunk)
        kp = torch.cat([k, k.new_zeros(nc * chunk - T, *k.shape[1:])])
        kp = kp.reshape(nc, chunk, *k.shape[1:])
        # running max / min inside each chunk: the box of a chunk's rows
        # before p is the running value at its last row before p
        cmax = kp.cummax(dim=1).values.reshape(nc * chunk, *k.shape[1:])
        cmin = kp.cummin(dim=1).values.reshape(nc * chunk, *k.shape[1:])
        qp = q.clamp(min=0).sum(dim=2)                    # (T, Hkv, d)
        qn = q.clamp(max=0).sum(dim=2)
        c = torch.arange(nc, device=dev)
        rate = self.rates[layer]
        for lo in range(S, T, self.block):
            P = torch.arange(lo, min(T, lo + self.block), device=dev)
            end = torch.minimum((c[None] + 1) * chunk, P[:, None])
            rows = (end - c[None] * chunk).clamp(min=0)     # (P, nc)
            idx = (end - 1).clamp(min=0)
            ub = (torch.einsum("pkd,pckd->pkc", qp[P], cmax[idx])
                  + torch.einsum("pkd,pckd->pkc", qn[P], cmin[idx]))
            score = ub.amax(dim=1).masked_fill(rows == 0, float("-inf"))
            order = torch.argsort(score, dim=1, descending=True, stable=True)
            size = rows.gather(1, order)
            before = size.cumsum(dim=1) - size
            budget = torch.clamp(torch.ceil(P.double() * rate).long(),
                                 min=chunk)
            budget = torch.minimum(budget, P)[:, None]
            take = (before < budget) & (size > 0)
            top = torch.zeros_like(take).scatter(1, order, take)
            have = np.zeros(tuple(top.shape), dtype=bool)
            for i, p in enumerate(P.tolist()):
                have[i, list(sample.sels[p][layer])] = True
            have = torch.from_numpy(have).to(dev)
            self.missed += int((top & ~have).sum())
            self.wanted += int(top.sum())


class _Keys:
    """Which key rows each query row attends at one layer: the exact rows
    (T, T) and, after them, the int4 copies of the chunks the pool held
    packed (``var``: (chunk, rows) in order, their rows in ``allow_var``
    (T, n_var))."""

    def __init__(self, sample: "Sample", layer: int, T: int, device):
        S, chunk = len(sample.prompt), sample.chunk
        exact = np.tril(np.ones((T, T), dtype=bool))
        self.var: List = []
        offs: Dict = {}
        pairs = []
        if T > S:
            n_chunks = -(-T // chunk)
            for p in range(S, T):
                sel = np.zeros(n_chunks, dtype=bool)
                sel[list(sample.sels[p][layer])] = True
                row = np.repeat(sel, chunk)[:T]
                row[p] = True
                row[p + 1:] = False
                exact[p] = row
                for c, n in sample.int4.get(p, {}).get(layer, {}).items():
                    if (c, n) not in offs:
                        offs[(c, n)] = sum(m for _, m in self.var)
                        self.var.append((c, n))
                    pairs.append((p, c, n))
        n_var = sum(m for _, m in self.var)
        allow_var = np.zeros((T, n_var), dtype=bool)
        for p, c, n in pairs:
            exact[p, c * chunk:c * chunk + n] = False
            allow_var[p, offs[(c, n)]:offs[(c, n)] + n] = True
        self.chunk = chunk
        self.allow = torch.from_numpy(
            np.concatenate([exact, allow_var], axis=1)).to(device)

    def extend(self, x: torch.Tensor) -> torch.Tensor:
        """Rows x (T, ...) with the int4 copies appended."""
        if not self.var:
            return x
        c0 = self.chunk
        return torch.cat([x] + [int4_round_trip(x[c * c0:c * c0 + n])
                                for c, n in self.var])


def _attend(mt: _Math, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            allow: torch.Tensor, scale: float, block: int = 512
            ) -> torch.Tensor:
    """q (T, H, dk), k (Tk, H, dk), v (Tk, H, dv) per head, allow (T, Tk)
    -> (T, H, dv)."""
    T = q.shape[0]
    kh, vh = mt.q(k).transpose(0, 1), mt.q(v).transpose(0, 1)
    qh = mt.q(q).transpose(0, 1)
    out = []
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        s = torch.matmul(qh[:, lo:hi], kh.transpose(1, 2)) * scale
        s = s.masked_fill(~allow[lo:hi][None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out.append(torch.matmul(mt.q(p), vh))
    return torch.cat(out, dim=1).transpose(0, 1)


def _gqa(mt: _Math, m: Dict, w: Dict, h: torch.Tensor, pos: torch.Tensor,
         keys: _Keys, score=None) -> torch.Tensor:
    T = h.shape[0]
    H, Hkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m["head_dim"]
    eps = m["rms_norm_eps"]
    q = mt.mm(h, w["wq"]).reshape(T, H, hd)
    k = mt.mm(h, w["wk"]).reshape(T, Hkv, hd)
    v = mt.mm(h, w["wv"]).reshape(T, Hkv, hd)
    if "q_norm" in w:
        q, k = _rms(q, w["q_norm"], eps), _rms(k, w["k_norm"], eps)
    theta = m["rope_theta"]
    q, k = _rope(q, pos, theta), _rope(k, pos, theta)
    G = H // Hkv
    if score is not None:
        score(q.reshape(T, Hkv, G, hd), k)
    k, v = keys.extend(k), keys.extend(v)
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    o = _attend(mt, q, k, v, keys.allow, 1.0 / math.sqrt(hd))
    return mt.mm(o.reshape(T, H * hd), w["wo"])


def _mla(mt: _Math, m: Dict, w: Dict, h: torch.Tensor, pos: torch.Tensor,
         keys: _Keys, score=None) -> torch.Tensor:
    T = h.shape[0]
    H = m["num_attention_heads"]
    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    nope, vd = m["qk_nope_head_dim"], m["v_head_dim"]
    theta = m["rope_theta"]
    q = mt.mm(h, w["wq"]).reshape(T, H, nope + rope)
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, theta)], -1)
    kv_a = mt.mm(h, w["wkv_a"])
    ckv = _rms(kv_a[:, :r], w["kv_norm"], m["rms_norm_eps"])
    krope = _rope(kv_a[:, None, r:], pos, theta)[:, 0]     # (T, rope)
    if score is not None:
        # scored in the latent space: W_UK folded into the query, one key
        # head whose rows are concat(ckv, krope)
        q_lat = torch.einsum("thd,hrd->thr", q[..., :nope], w["wk_b"])
        score(torch.cat([q_lat, q[..., nope:]], dim=-1)[:, None],
              torch.cat([ckv, krope], dim=-1)[:, None])
    # the tiered row is the latent concat(ckv, krope): the int4 copies
    # are of that row, then expanded like the exact ones
    lat = keys.extend(torch.cat([ckv, krope], dim=-1))
    Tk = lat.shape[0]
    ckv, krope = lat[:, :r], lat[:, r:]
    k_nope = mt.einsum("tr,hrd->thd", ckv, w["wk_b"])
    val = mt.einsum("tr,hrd->thd", ckv, w["wv_b"])
    k = torch.cat([k_nope, krope[:, None].expand(Tk, H, rope)], dim=-1)
    o = _attend(mt, q, k, val, keys.allow, 1.0 / math.sqrt(nope + rope))
    return mt.mm(o.reshape(T, H * vd), w["wo"])


def _swiglu(mt: _Math, x: torch.Tensor, up, gate, down) -> torch.Tensor:
    return mt.mm(torch.nn.functional.silu(mt.mm(x, gate)) * mt.mm(x, up),
                 down)


def _moe(mt: _Math, m: Dict, w: Dict, x: torch.Tensor) -> torch.Tensor:
    K = m["num_experts_per_tok"]
    probs = torch.softmax(mt.mm(x, w["router"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    if m.get("norm_topk_prob"):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in torch.unique(top_e).tolist():
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        ye = _swiglu(mt, x[tok], w["w_up"][e], w["w_gate"][e],
                     w["w_down"][e])
        y.index_add_(0, tok, ye * top_p[tok, slot][:, None])
    if "shared_w_up" in w:
        y = y + _swiglu(mt, x, w["shared_w_up"], w["shared_w_gate"],
                        w["shared_w_down"])
    return y


def logits(m: Dict, layers: List[Dict], head: Dict,
           samples: Sequence[Sample], *, precision: str = "f32",
           device=None, evaluation: Optional[Evaluation] = None
           ) -> List[torch.Tensor]:
    """The logits rows (len(served), V) f32 that chose each sample's
    served tokens, layer by layer over every sample (one layer's weights
    in float32 at a time); with ``evaluation``, each layer's chunk
    selections are judged on the way."""
    no_tf32()
    mt = _Math(precision)
    dev = torch.device(device) if device is not None else \
        head["embed"].device
    eps = m["rms_norm_eps"]
    toks = [torch.from_numpy(s.tokens).to(dev) for s in samples]
    # the table is held at the chosen precision: its rows carry its
    # rounding
    E = mt.q(head["embed"].float())
    xs = [E[t] for t in toks]
    mla = m.get("kv_lora_rank") is not None
    for li, wl in enumerate(layers):
        w = _f32(wl)
        attn = _mla if mla else _gqa
        for i, s in enumerate(samples):
            T = len(s.tokens)
            pos = torch.arange(T, device=dev)
            keys = _Keys(s, li, T, dev)
            h = _rms(xs[i], w["ln1"], eps)
            score = None if evaluation is None else \
                functools.partial(evaluation.add, s, li)
            xs[i] = xs[i] + attn(mt, m, w["core"], h, pos, keys, score)
        # the MLP over every sample's rows at once
        x = torch.cat(xs)
        h = _rms(x, w["ln2"], eps)
        mw = w["mlp"]
        if _is_moe(m, li):
            x = x + _moe(mt, m, mw, h)
        else:
            x = x + _swiglu(mt, h, mw["w_up"], mw["w_gate"], mw["w_down"])
        xs = list(torch.split(x, [len(s.tokens) for s in samples]))
        del w
    out_w = head["lm_head"].float() if "lm_head" in head else E.T
    return [mt.mm(_rms(xs[i][list(s.rows)], head["final_norm"], eps),
                  out_w) for i, s in enumerate(samples)]


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per row, how far the chosen token's reference logit lies below the
    reference's best, in units of that row's standard deviation over the
    vocabulary."""
    best = ref.max(dim=-1).values
    at = ref.gather(1, chosen.long().view(-1, 1))[:, 0]
    return (best - at) / ref.std(dim=-1)


def widest_gap(ref_rows: Sequence[torch.Tensor],
               chosen: Sequence[torch.Tensor]) -> float:
    """The widest gap over every row of every sample."""
    return float(max(gaps(r, c.to(r.device)).max().item()
                     for r, c in zip(ref_rows, chosen)))


def mean_gap(ref_rows: Sequence[torch.Tensor],
             chosen: Sequence[torch.Tensor]) -> float:
    """The mean gap over every row of every sample."""
    g = torch.cat([gaps(r, c.to(r.device)) for r, c in zip(ref_rows, chosen)])
    return float(g.mean().item())


def gap_quantiles(ref_rows: Sequence[torch.Tensor],
                  chosen: Sequence[torch.Tensor]) -> Dict[str, float]:
    g = torch.cat([gaps(r, c.to(r.device)) for r, c in zip(ref_rows, chosen)])
    q = torch.quantile(g.float().cpu(), torch.tensor([0.5, 0.9, 0.99]))
    return {"mean": float(g.mean()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": float(g.max()),
            "nonzero": float((g > 0).float().mean())}


def served_tensor(s: Sample) -> torch.Tensor:
    return torch.tensor(s.served, dtype=torch.int64)


