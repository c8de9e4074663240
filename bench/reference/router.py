"""Plain NumPy reference of the placement service: Algorithm 1 of Jung &
Lee (arXiv 2111.07006) for one job at a time, against queues that the
fluid model drains between arrivals.

It imports nothing of the program.  Its own copies: the USNET backbone
of the paper's Fig. 4 (the 43 links, capacities and ingress/egress sets
of the repo's scenario catalog), the LM cost profile that turns a model
configuration into a job, and the nominal arrival rate.

Semantics, operation by operation, in float32 unless said otherwise:

* drain to time t: dt = t - now in float64, rounded to float32;
  q <- max(q - mu dt, 0) with ``q - mu dt`` rounded once (a fused
  multiply-add), on nodes and links;
* edge weights of layer l: w_l = min((d_l + Q) * (1 / mu), INF), 0 on the
  diagonal, INF = float32(1e30) where there is no link;
* T_l: w_l closed under (min, +) by ceil(log2(V - 1)) squarings;
* the layer DP g_0 = T_0[src] + Q_u/mu_u, then per layer
  g_l = fma(c_l, 1/mu, min(g_{l-1}, min_v g_{l-1}[v] + T_{l-1}[v] + Q_u/mu_u))
  clipped at INF; the bound min_u g_L[u] + T_L[u, dst]; ties go to the
  lower index; the assignment by walking the back-pointers;
* paths hop by hop: from u the next node is the argmin over x != u of
  w_l[u, x] + T_l[x, dst];
* the commit adds c_l to its node in layer order and d_l to every hop's
  link, layer by layer, hop by hop, one rounding per add;
* backlog: the largest Q/mu over nodes and links, in float64.

``precision="bfloat16"`` rounds the result of every float32 operation to
bfloat16: the control that a comparison has to fail.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32
INF = F32(1e30)
G, MB = 1e9, 1e6

# USNET: 24 nodes, 43 bidirectional links; node compute cycles through
# [30, 50, 200, 100, 70] GFLOP/s, a link carries 375 MB/s where u + v is
# even and 125 MB/s where it is odd (times the capacity scale)
US_BACKBONE_EDGES = [
    (0, 1), (0, 5), (1, 2), (1, 5), (2, 3), (2, 4), (3, 4), (3, 6),
    (4, 7), (5, 8), (5, 10), (6, 7), (6, 9), (7, 9), (8, 9), (8, 10),
    (9, 12), (10, 11), (10, 13), (11, 12), (11, 14), (12, 15), (13, 14),
    (13, 16), (14, 15), (14, 18), (15, 19), (16, 17), (16, 20), (17, 18),
    (17, 21), (18, 19), (18, 22), (19, 23), (20, 21), (21, 22), (22, 23),
    (2, 6), (9, 13), (12, 14), (20, 22), (4, 6), (11, 15),
]
US_BACKBONE_INGRESS = (0, 5, 10, 20)
US_BACKBONE_EGRESS = (4, 9, 15, 23)


def us_backbone(capacity_scale: float) -> tuple[np.ndarray, np.ndarray]:
    """(mu_node [24] FLOP/s, mu_link [24, 24] bytes/s), float32."""
    cycle = [30, 50, 200, 100, 70]
    mu_node = np.asarray([cycle[i % 5] * G for i in range(24)], F32)
    mu_link = np.zeros((24, 24), F32)
    for u, v in US_BACKBONE_EDGES:
        cap = (375 if (u + v) % 2 == 0 else 125) * MB * capacity_scale
        mu_link[u, v] = mu_link[v, u] = cap
    return mu_node, mu_link


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


def cost_profile(cfg: dict, *, seq_len: int, batch: int = 1,
                 act_bytes: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """(comp [L] FLOPs, data [L+1] bytes) of a ``batch`` x ``seq_len``
    inference of an attention LM (dense or MoE): layers embed, the
    blocks, head; data[0] the token ids, then the hidden state handed on,
    data[-1] the predicted ids.  Float64."""
    b, s, d = batch, seq_len, cfg["hidden_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    attn = 2.0 * b * s * ((d * h * hd + 2 * d * kv * hd + h * hd * d)
                          + s * h * hd * 2)
    if cfg.get("num_experts"):
        f = cfg["intermediate_size"]
        ffn = 2.0 * b * s * (3 * d * f * cfg["num_experts_per_tok"]
                             + d * cfg["num_experts"])
    else:
        ffn = 2.0 * b * s * 3 * d * cfg["intermediate_size"]
    layers = cfg["num_hidden_layers"]
    hidden = float(b * s * d * act_bytes)
    comp = ([2.0 * b * s * d] + [ffn + attn] * layers
            + [2.0 * b * s * d * pad_vocab(cfg["vocab_size"])])
    data = [float(b * s * 4)] + [hidden] * (layers + 1) + [float(b * s * 4)]
    return np.asarray(comp, np.float64), np.asarray(data, np.float64)


def fma_f32(a, b, c) -> np.ndarray:
    """a * b + c of float32 operands, rounded once to float32: the float64
    product is exact, the float64 sum is made round-to-odd, and rounding a
    round-to-odd value to float32 rounds correctly."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(np.int64) & 1) == 0
    away = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, away), s)
    with np.errstate(over="ignore"):
        return s.astype(F32)


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept as float32."""
    x = np.asarray(x, F32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(F32)


class Router:
    """The placement service's state and Algorithm 1, one job a call."""

    def __init__(self, mu_node, mu_link, *, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        self.r = (lambda x: np.asarray(x, F32)) if precision == "float32" \
            else to_bf16
        self.mu_node = np.asarray(mu_node, F32)
        self.mu_link = np.asarray(mu_link, F32)
        self.v = self.mu_node.shape[0]
        self.q_node = np.zeros_like(self.mu_node)
        self.q_link = np.zeros_like(self.mu_link)
        self.now = 0.0
        r = self.r
        with np.errstate(divide="ignore"):
            self.cinv = np.where(self.mu_node > 0,
                                 r(F32(1) / np.maximum(self.mu_node,
                                                       F32(1e-30))), INF)
            inv = np.where(self.mu_link > 0,
                           r(F32(1) / np.maximum(self.mu_link, F32(1e-30))),
                           INF).astype(F32)
        np.fill_diagonal(inv, 0)
        self.link_inv = inv
        self.steps = max(1, (self.v - 1).bit_length())

    # -- state ---------------------------------------------------------------
    def advance_to(self, t: float) -> None:
        dt = max(float(t) - self.now, 0.0)
        if dt > 0:
            dt32 = F32(dt)
            self.q_node = np.maximum(self.r(fma_f32(-self.mu_node, dt32,
                                                    self.q_node)), F32(0))
            self.q_link = np.maximum(self.r(fma_f32(-self.mu_link, dt32,
                                                    self.q_link)), F32(0))
        self.now = max(self.now, float(t))

    def backlog_s(self) -> float:
        def wait(q, mu):
            mu = mu.astype(np.float64)
            return np.where(mu > 0, q.astype(np.float64)
                            / np.maximum(mu, 1e-30), 0.0)
        return float(max(wait(self.q_node, self.mu_node).max(initial=0.0),
                         wait(self.q_link, self.mu_link).max(initial=0.0)))

    # -- Algorithm 1 for one job -----------------------------------------------
    def weights(self, d) -> np.ndarray:
        w = self.r(self.r(F32(d) + self.q_link) * self.link_inv)
        return np.minimum(w, INF)

    def close(self, w: np.ndarray) -> np.ndarray:
        t = w.copy()
        np.fill_diagonal(t, 0)
        for _ in range(self.steps):
            t = self.r(t[:, :, None] + t[None, :, :]).min(axis=1)
        return t

    def place(self, comp, data, src: int, dst: int) -> dict:
        """Route and commit one job; returns its assignment, paths, bound
        (float64 of the float32 bound) and the backlog before and after."""
        r = self.r
        comp = np.asarray(comp, F32)
        data = np.asarray(data, F32)
        L = comp.shape[0]
        before = self.backlog_s()
        closures = {}
        for dv in np.unique(data):
            w = self.weights(dv)
            closures[dv] = (w, self.close(w))
        ws = [closures[dv][0] for dv in data]
        ts = [closures[dv][1] for dv in data]
        with np.errstate(divide="ignore", invalid="ignore"):
            nw = np.where(self.mu_node > 0,
                          r(self.q_node / np.maximum(self.mu_node,
                                                     F32(1e-30))), F32(0))
        g = r(ts[0][src] + nw)
        bps = []
        for l in range(1, L + 1):
            cand = r(g[:, None] + ts[l - 1])
            move, move_bp = cand.min(axis=0), cand.argmin(axis=0)
            moved = r(move + nw)
            stay = g <= moved
            g_new = np.minimum(r(fma_f32(comp[l - 1], self.cinv,
                                         np.minimum(g, moved))), INF)
            bps.append(np.where(stay, -1, move_bp))
            g = g_new
        total = r(g + ts[L][:, dst])
        bound = min(F32(total.min()), INF)
        cur = int(np.argmin(total))
        assign = np.empty(L, np.int32)
        for l in range(L - 1, -1, -1):
            assign[l] = cur
            prev = int(bps[l][cur])
            cur = cur if prev < 0 else prev
        nodes = [src] + assign.tolist() + [dst]
        paths = []
        for l in range(L + 1):
            hops, cur, end = [], nodes[l], nodes[l + 1]
            for _ in range(self.v):
                if cur == end:
                    break
                cand = r(ws[l][cur] + ts[l][:, end])
                cand[cur] = INF
                nxt = int(np.argmin(cand))
                hops.append((cur, nxt))
                cur = nxt
            paths.append(hops)
        for l in range(L):
            a = assign[l]
            self.q_node[a] = r(self.q_node[a] + comp[l])
        for l, hops in enumerate(paths):
            for u, v in hops:
                if u != v:
                    self.q_link[u, v] = r(self.q_link[u, v] + data[l])
        return {"assign": assign, "paths": paths, "bound": float(bound),
                "priority": 0, "backlog_before": before,
                "backlog_after": self.backlog_s()}


def mean_service_s(mu_node, mu_link, comp, data, pairs) -> float:
    """Mean empty-network optimal completion of the job over the (src,
    dst) pairs, in float64 (a float32 bound each)."""
    costs = []
    for s, d in pairs:
        costs.append(Router(mu_node, mu_link).place(comp, data, s, d)["bound"])
    return float(np.mean(np.asarray(costs, np.float64)))


def nominal_rate(load: float, mean_s: float) -> float:
    """Arrivals per second that offer ``load`` times one-at-a-time service
    capacity (the repo's ``Scenario.nominal_rate``)."""
    return load / max(mean_s, 1e-30)
