"""Offline serving of a decentralised model (counterpart of ``repro/fed/serve.py``).

Decentralised training's end product is an ensemble: every node holds its
own parameters, equal only up to the consensus noise floor.  This module
serves it two ways:

* ``consensus_params`` averages the ensemble into one parameter set and
  ``generate`` / ``ServeEngine.generate`` answer a batch from it: one
  batched prefill (``prefill_cache``: on the card every attention layer is
  one flash kernel launch and every RWKV layer one rwkv kernel launch) and
  then a decode loop, one token per step;
* ``ServeEngine.serve`` answers each query from the node it is assigned to,
  reading that node's parameters as views of the ensemble.

The cache is the decoder's: KV caches of ``cache_len`` slots for attention
layers, an O(1) token-shift and wkv state for RWKV layers and an O(1) conv
tail and SSM state for mamba layers, which ignore ``cache_len``, as in the
JAX package.  Greedy decoding emits the JAX
package's tokens on the same parameters.
Temperature sampling draws Gumbel noise from a ``torch.Generator`` (one
(B, V) draw per sampled token), so a run is reproducible for a given
generator but does not reproduce JAX's threefry draws.

Live serving: ``run_serve_trajectory`` merges an open-loop Poisson
``QueryStream`` into the gossip ``EventStream``'s envelope and walks both
on the host.  Gossip events run the event executor's own step and
bookkeeping (``executor._EventRun``: the same seed, the failure flag of the
gossip ordinal), so training is bitwise that of ``run_event_trajectory``
whatever the query load; query events route to a node (``fed.router``),
read its current parameters and settle a queueing latency model on the
same virtual clocks.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.commplan import CommPlan
from repro_torch.core.topology import EventStream, Graph
from repro_torch.device import resolve_device
from repro_torch.flat import tree_map
from repro_torch.gossip.engine import split_seed
from repro_torch.models import transformer as tf

from . import router as _router
from .executor import _EventRun
from .router import QueryStream, Router
from .trainer import DFLState

Tree = dict[str, Any]

__all__ = [
    "ServeEngine",
    "consensus_params",
    "decode_one",
    "generate",
    "generate_tokenwise",
    "prefill",
    "run_serve_trajectory",
    "serve_summary",
]

_CHUNK = 1 << 26  # elements averaged at a time: bounds the fp32 transient to 256 MB


@torch.no_grad()
def consensus_params(node_params: Tree, weights: torch.Tensor | np.ndarray | None = None) -> Tree:
    """Average the node ensemble (every leaf (n, ...)) into one parameter set.

    Leaf by leaf and chunk by chunk in fp32, each result in its leaf's
    dtype: no fp32 copy of the ensemble, or of one whole leaf, is built.
    ``weights`` (n,) are normalised to sum to one; None is the plain mean.
    """
    w = None if weights is None else np.asarray(torch.as_tensor(weights).cpu(), np.float64)
    if w is not None:
        w = (w / w.sum()).astype(np.float32)

    def avg(leaf: torch.Tensor) -> torch.Tensor:
        n = leaf.shape[0]
        flat = leaf.reshape(n, -1)
        out = torch.empty(flat.shape[1], dtype=leaf.dtype, device=leaf.device)
        for c0 in range(0, flat.shape[1], _CHUNK):
            part = flat[:, c0 : c0 + _CHUNK]
            if w is None:
                acc = part[0].to(torch.float32, copy=True)  # never an alias of the ensemble
                for i in range(1, n):
                    acc += part[i].float()
                acc /= n
            else:
                acc = part[0].float() * float(w[0])
                for i in range(1, n):
                    acc += part[i].float() * float(w[i])
            out[c0 : c0 + _CHUNK] = acc.to(leaf.dtype)
        return out.reshape(leaf.shape[1:])

    return tree_map(avg, node_params)


@torch.no_grad()
def prefill(
    params: Tree, cfg: ArchConfig, tokens: torch.Tensor, frontend_embeds: torch.Tensor | None = None
) -> torch.Tensor:
    """Full-sequence forward → next-token logits of the LAST position only
    ((..., V)); the full logits never materialise (vocab can be 262k).
    ``frontend_embeds`` (..., F, E) is passed on to ``forward``, which puts
    their projection before the tokens for a config with a frontend (llava,
    musicgen, llama4-scout) and ignores them otherwise.  ``generate`` and
    ``ServeEngine`` stay text-only, as the JAX package's."""
    hidden, _ = tf.forward(params, cfg, tokens, frontend_embeds, remat=False)
    return tf.hidden_to_logits(params, cfg, hidden[..., -1:, :])[..., 0, :]


def decode_one(params: Tree, cfg: ArchConfig, cache: Tree, tokens: torch.Tensor, pos: int):
    """ONE new token against the cache: tokens (B, 1) at absolute ``pos``."""
    return tf.decode_step(params, cfg, cache, tokens, pos)


def _sample(logits: torch.Tensor, temperature: float, generator: torch.Generator | None) -> torch.Tensor:
    if temperature > 0:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        return torch.argmax(logits.float() / temperature - torch.log(-torch.log(u)), dim=-1)
    return torch.argmax(logits, dim=-1)


def _setup(prompt, temperature: float, generator, device):
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=dev)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return prompt, generator


@torch.no_grad()
def generate(
    params: Tree,
    cfg: ArchConfig,
    prompt,
    n_new: int,
    cache_len: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Greedy / temperature sampling: one batched prefill, then ``n_new - 1``
    decode steps.  prompt (..., S) → new tokens (..., n_new) in prompt's dtype."""
    prompt, generator = _setup(prompt, temperature, generator, device)
    s = prompt.shape[-1]
    logits, cache = tf.prefill_cache(params, cfg, prompt, cache_len)
    tok = _sample(logits, temperature, generator).to(prompt.dtype)
    out = [tok]
    for i in range(int(n_new) - 1):
        logits, cache = tf.decode_step(params, cfg, cache, tok[..., None], s + i)
        tok = _sample(logits[..., -1, :], temperature, generator).to(prompt.dtype)
        out.append(tok)
    return torch.stack(out, dim=-1)


@torch.no_grad()
def generate_tokenwise(
    params: Tree,
    cfg: ArchConfig,
    prompt,
    n_new: int,
    cache_len: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """Reference decode loop: the prompt (B, S) is consumed one token at a
    time, the parity baseline for ``generate``'s prefill path."""
    prompt, generator = _setup(prompt, temperature, generator, device)
    cache = tf.init_cache(cfg, (prompt.shape[0],), cache_len, device=prompt.device)
    for t in range(prompt.shape[1] - 1):
        _, cache = tf.decode_step(params, cfg, cache, prompt[:, t : t + 1], t)
    pos = prompt.shape[1] - 1
    tok = prompt[:, -1:]
    out = []
    for _ in range(int(n_new)):
        logits, cache = tf.decode_step(params, cfg, cache, tok, pos)
        pos += 1
        tok = _sample(logits[:, -1], temperature, generator).to(prompt.dtype)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


class ServeEngine:
    """Batched prefill → decode engine over one parameter set or a
    node-stacked ensemble, on ``device`` (default ``cuda``).

    ``generate`` serves a batch against ONE parameter set (e.g. the
    consensus); ``serve`` answers each query with its assigned node's
    parameters (views of the ensemble, never a gathered copy), one
    ``generate`` per query.
    """

    def __init__(self, cfg: ArchConfig, cache_len: int, temperature: float = 0.0, *, device=None):
        self.cfg = cfg
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.device = resolve_device(device)

    def generate(self, params: Tree, prompt, n_new: int, generator: torch.Generator | None = None) -> torch.Tensor:
        return generate(
            params, self.cfg, prompt, n_new, self.cache_len, self.temperature, generator, device=self.device
        )

    def serve(
        self, node_params: Tree, assignments, prompts, n_new: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """prompts (B, S) answered by the nodes in ``assignments`` (B,) → (B, n_new)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        nodes = [int(a) for a in np.asarray(torch.as_tensor(assignments).cpu())]
        if len(nodes) != prompts.shape[0]:
            raise ValueError(f"{len(nodes)} assignments for {prompts.shape[0]} prompts")
        out = []
        for i, node in enumerate(nodes):
            params = tree_map(lambda leaf: leaf[node], node_params)
            out.append(self.generate(params, prompts[i : i + 1], n_new, generator)[0])
        return torch.stack(out)


# ------------------------------------------------------- interleaved serving
def run_serve_trajectory(
    state: DFLState,
    loss_fn,
    optimizer,
    plan: CommPlan | Graph,
    stream: EventStream,
    queries: QueryStream,
    router: Router,
    xs: np.ndarray | torch.Tensor,
    ys: np.ndarray | torch.Tensor,
    schedule: np.ndarray,
    *,
    b_local: int,
    n_bins: int = 20,
    eval_fn=None,
    eval_batch=None,
    reinit_opt: bool = True,
    service_time: float = 0.05,
    hop_latency: float = 0.02,
    serve_fn: Callable[[Tree, torch.Tensor], torch.Tensor] | None = None,
    query_xs: np.ndarray | torch.Tensor | None = None,
    chunk_events: int = 0,
    on_chunk=None,
    device: str | torch.device | None = None,
) -> tuple[DFLState, dict[str, list], dict[str, np.ndarray], dict]:
    """Interleaved train + serve over the merged gossip + query envelope.

    The host merges the two sorted envelopes with a stable argsort (gossip
    before queries at equal times; at qps = 0 the identity) and walks it.
    A live gossip event is ``run_event_trajectory``'s event: the same step,
    its failure flag row g (the gossip ordinal) of the flags drawn from the
    run's one seed, the same bins.  A live query event at time t from home
    node ``home``:

    1. routes to ``v = router.route(home, t − clocks, max(busy − t, 0),
       draw)``, the staleness read off the training's virtual clocks, the
       queue wait off the per-node busy-until times, ``draw`` the query's
       row of ``router.uniform_draws`` (from a child of the run's seed);
    2. settles ``latency = (start − t) + service_time + hop_latency ·
       hops(home, v)`` with ``start = max(t, busy[v])`` and moves
       ``busy[v]`` to ``start + service_time`` (one serving slot a node),
       all in float32 on the host;
    3. with ``serve_fn``, answers it: ``serve_fn(node v's parameters as
       views, query_xs[qidx])`` on the device, the answer kept in a device
       tensor read once at the end.  Queries never write parameters.

    Returns ``(final_state, hist, serve, aux)``: ``hist`` the event
    executor's per-bin history plus ``queries`` / ``serve_latency`` /
    ``serve_staleness``; ``serve`` the per-query arrays (time, home, node,
    latency, staleness, hops, answer) in arrival order; ``aux`` the per-node
    clocks, event counts and busy times and the staleness histogram.
    ``on_chunk(ci, i0, i1, acc)`` fires after each chunk of
    ``chunk_events`` merged events, with the accumulators so far as numpy.
    """
    if abs(queries.horizon - stream.horizon) > 1e-6:
        raise ValueError("query stream and event stream must share one horizon")
    run = _EventRun(state, loss_fn, optimizer, plan, stream, xs, ys, schedule, b_local=b_local, n_bins=n_bins,
                    eval_fn=eval_fn, eval_batch=eval_batch, reinit_opt=reinit_opt, comp=None, device=device,
                    name="run_serve_trajectory")
    dev = run.dev
    qx_d = None if query_xs is None else torch.as_tensor(query_xs, device=dev)
    draws = None
    if router.policy == "uniform":
        if run.seed is None:
            raise ValueError("a uniform router draws from the run's seed: the state needs a generator")
        draws = _router.uniform_draws(router.n, split_seed(run.seed, 1)[0], queries.envelope)

    # host-side merge of the two sorted envelopes
    env_g, env_q = stream.envelope, queries.envelope
    times = np.concatenate([np.asarray(stream.times), np.asarray(queries.times)])
    is_query = np.concatenate([np.zeros(env_g, bool), np.ones(env_q, bool)])
    ordinal = np.concatenate([np.arange(env_g), np.arange(env_q)])
    order = np.argsort(times, kind="stable")
    times, is_query, ordinal = times[order], is_query[order], ordinal[order]
    q_bins = np.clip((np.asarray(queries.times) / stream.horizon * n_bins).astype(np.int64), 0, n_bins - 1)

    f32 = np.float32
    service, per_hop = f32(service_time), f32(hop_latency)
    busy = np.zeros(router.n, dtype=f32)
    lat_sum, stale_sum, q_cnt = (np.zeros(n_bins, dtype=f32) for _ in range(3))
    node = np.full(env_q, -1, dtype=np.int64)
    latency, staleness, hops = (np.zeros(env_q, dtype=f32) for _ in range(3))
    answers = torch.full((env_q,), float("nan"), dtype=torch.float32, device=dev)

    def serve_one(qn: int) -> None:
        home = int(queries.homes[qn])
        t = f32(queries.times[qn])
        clocks = run.clocks
        v = router.route(home, t - clocks, np.maximum(busy - t, f32(0.0)), None if draws is None else draws[qn])
        start = max(t, busy[v])
        h = router.hops[home, v]
        lat = (start - t) + service + per_hop * h
        stale_v = t - clocks[v]
        busy[v] = start + service
        if serve_fn is not None and qx_d is not None:
            st = run.state
            with torch.no_grad():
                ans = serve_fn(st.layout.views(st.params[v]), qx_d[int(queries.qidx[qn])])
                answers[qn : qn + 1].copy_(torch.as_tensor(ans, device=dev).to(torch.float32).reshape(1))
        b = int(q_bins[qn])
        lat_sum[b] += lat
        stale_sum[b] += stale_v
        q_cnt[b] += f32(1.0)
        node[qn], latency[qn], staleness[qn], hops[qn] = v, lat, stale_v, h

    env = env_g + env_q
    size = env if chunk_events <= 0 else int(chunk_events)
    for ci, i0 in enumerate(range(0, env, size)):
        i1 = min(i0 + size, env)
        for j in range(i0, i1):
            k = int(ordinal[j])
            if not is_query[j]:
                if run.live[k]:
                    run.gossip(k)
            elif queries.homes[k] >= 0:
                serve_one(k)
        if on_chunk is not None:
            on_chunk(ci, i0, i1, dict(run.acc(), serve_lat_sum=lat_sum.copy(), serve_stale_sum=stale_sum.copy(),
                                      serve_cnt=q_cnt.copy()))

    hist = run.history()
    q_safe = np.maximum(q_cnt, f32(1.0))
    hist["queries"] = [int(v) for v in q_cnt]
    hist["serve_latency"] = [float(v) for v in lat_sum / q_safe]
    hist["serve_staleness"] = [float(v) for v in stale_sum / q_safe]
    q = np.nonzero(np.asarray(queries.homes) >= 0)[0]
    serve = {
        "time": np.asarray(queries.times)[q].astype(np.float64),
        "home": np.asarray(queries.homes)[q].astype(np.int64),
        "node": node[q],
        "latency": latency[q].astype(np.float64),
        "staleness": staleness[q].astype(np.float64),
        "hops": hops[q].astype(np.float64),
        "answer": answers.cpu().numpy()[q].astype(np.float64),
    }
    aux = dict(run.aux(), node_busy=busy)
    return run.final(), hist, serve, aux


def serve_summary(serve: dict[str, np.ndarray]) -> dict[str, float]:
    """Headline latency / staleness stats of one ``run_serve_trajectory`` run."""
    lat = np.asarray(serve["latency"], np.float64)
    if lat.size == 0:
        return {"served": 0, "p50_latency": 0.0, "p95_latency": 0.0, "mean_latency": 0.0, "mean_staleness": 0.0,
                "mean_hops": 0.0}
    return {
        "served": int(lat.size),
        "p50_latency": float(np.percentile(lat, 50)),
        "p95_latency": float(np.percentile(lat, 95)),
        "mean_latency": float(lat.mean()),
        "mean_staleness": float(np.asarray(serve["staleness"]).mean()),
        "mean_hops": float(np.asarray(serve["hops"]).mean()),
    }
