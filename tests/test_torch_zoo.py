"""The zoo's last four configurations and RWKV training in the port, against
the JAX package on the same numpy-seeded parameters.

* The configs: jamba-1.5-large-398b (mamba + attention, MoE at odd
  layers), llava-next-mistral-7b (vision frontend), musicgen-large (audio
  frontend, layernorm, GELU MLP) and llama4-scout-17b-a16e (top-1 MoE at
  every layer, a vision projector but text-only inputs) field for field,
  their parameter counts, and the full-width depth cuts the card serves.
* The reduced decoders, fp32: ``forward``, ``prefill_cache(frontend_embeds=)``
  (logits and every cache leaf) and four ``decode_step`` calls from
  position F + S, all to ``TOL`` (rtol 1e-4, atol 1e-5), with 8 frontend
  embeddings for llava and musicgen; ``serve.prefill`` with them.
* Decode against prefill in the port alone at ``capacity_factor=8.0`` (no
  token dropped), for the JAX ``tests/test_decode_consistency.py`` cases
  and the two vision configs: relative error < 5e-4, the JAX bound.
* RWKV training: the rwkv6-3b node loss and its gradient against
  ``jax.value_and_grad`` (the recorded time-mix runs the plain chunked form),
  and ``--model rwkv`` / ``--arch <config> --reduced`` through the CLI, the
  ``--arch`` runs' losses against the JAX ``train_loop`` on the same params
  and token batches (the JAX CLI's loss, SGD, the complete graph).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy, state_from_numpy  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.flat import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import train as p_cli  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402
from test_torch_mamba import mamba_numpy_params  # noqa: E402
from test_torch_rwkv import _MetaGenerator  # noqa: E402
from test_torch_rwkv import numpy_params as rwkv_numpy_params  # noqa: E402
from test_torch_transformer import _assert_tree_close, numpy_params  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
NEW = ["jamba_1p5_large_398b", "llava_next_mistral_7b", "musicgen_large", "llama4_scout_17b_a16e"]
PROMPT_LEN, CACHE_LEN, N_DECODE = 40, 64, 4
# elements of the trees phase 7d of chip_smoke.py draws (JAX eval_shape)
ELEMENTS = {"jamba-1.5-large-398b": 24_045_707_264, "musicgen-large": 2_426_804_224,
            "llama4-scout-17b-a16e": 18_686_371_840}


def setup_module(module):
    torch.set_num_threads(1)


def zoo_params(jcfg, seed: int = 0, n_nodes: int | None = None) -> dict:
    """``test_torch_transformer.numpy_params`` (the JAX layout: dense
    weights normal / √fan_in, norms and biases perturbed) with each mamba
    block's leaves drawn in their working ranges
    (``test_torch_mamba.mamba_numpy_params``)."""
    params = numpy_params(jcfg, seed=seed, n_nodes=n_nodes)
    lead = (n_nodes,) if n_nodes else ()
    for j, block in enumerate(params["stack"]):
        if "mamba" in block:
            periods = block["mamba"]["a_log"].shape[len(lead)]
            block["mamba"] = mamba_numpy_params(jcfg, seed=seed + 100 + j, lead=lead + (periods,))
    for j, block in enumerate(params["tail"]):
        if "mamba" in block:
            block["mamba"] = mamba_numpy_params(jcfg, seed=seed + 200 + j, lead=lead)
    return params


def frontend_embeds(cfg, batch: int = 2, seed: int = 1):
    """(batch, F, E) numpy embeddings for a config with frontend tokens, else None."""
    if not (cfg.frontend and cfg.n_frontend_tokens):
        return None
    shape = (batch, cfg.n_frontend_tokens, cfg.frontend_embed_dim)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", NEW)
def test_configs_match_jax(arch):
    for getter in ("get_config", "get_reduced_config"):
        j, p = getattr(jbase, getter)(arch), getattr(pbase, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert p.n_params() == j.n_params() and p.n_active_params() == j.n_active_params()
        assert pbase.layer_kinds(p) == jbase.layer_kinds(j) and pbase.ffn_kinds(p) == jbase.ffn_kinds(j)
        assert PTF.unit_size(p) == JTF.unit_size(j) and PTF._split_layers(p) == JTF._split_layers(j)
    assert pbase.get_config(arch).param_dtype == torch.bfloat16
    assert pbase.get_reduced_config(arch).param_dtype == torch.float32


def test_registry_resolves_the_ten_configs():
    assert pbase.list_archs() == jbase.list_archs()
    assert len(pbase.list_archs()) == 10
    for arch in ("jamba-1.5-large-398b", "llava-next-mistral-7b", "musicgen-large", "llama4-scout-17b-a16e"):
        assert pbase.get_config(arch).name == arch
    with pytest.raises(ValueError, match="unknown"):
        pbase.get_config("gpt-9")
    with pytest.raises(ValueError, match="unknown block kind"):
        PTF.init_params(0, dataclasses.replace(pbase.get_reduced_config("qwen2.5-3b"), block_pattern=("conv",)),
                        InitConfig(), device="cpu")


@pytest.mark.parametrize("arch,layers,want", [
    ("jamba-1.5-large-398b", None, 397_497_106_432),
    ("jamba-1.5-large-398b", 5, 23_978_524_672),
    ("llava-next-mistral-7b", None, 7_241_728_000),
    ("musicgen-large", None, 2_424_504_320),
    ("llama4-scout-17b-a16e", None, 101_730_058_240),
    ("llama4-scout-17b-a16e", 8, 18_679_152_640),
])
def test_full_width_parameter_counts_and_depth_cuts(arch, layers, want, monkeypatch):
    """The full-width configs and the depth cuts the card serves (jamba at 5
    layers: 4 mamba blocks, MoE at layers 1 and 3, the attention block at 4;
    llama4-scout at 8), both packages' counts; the cuts' trees, built on the
    meta device (nothing drawn), against ``jax.eval_shape`` of the JAX
    ``init_params`` leaf for leaf (shapes, dtypes), and their elements: the
    JAX formula leaves out the final norm, the layernorm biases and the
    frontend projector, and for jamba the MoE routers and part of each mamba block's x_proj / dt_proj
    (the tree holds 67,174,400 more: 24,045,707,264)."""
    from repro_torch.models import common as PC

    j, p = jbase.get_config(arch), pbase.get_config(arch)
    if layers:
        j, p = dataclasses.replace(j, n_layers=layers), dataclasses.replace(p, n_layers=layers)
    assert p.n_params() == j.n_params() == want
    if layers == 5:
        assert pbase.layer_kinds(p) == ["mamba"] * 4 + ["attn"]
        assert pbase.ffn_kinds(p) == ["dense", "moe", "dense", "moe", "dense"]
    if arch != "musicgen-large" and not layers:
        return
    monkeypatch.setattr(PC, "scaled_init", lambda cfg, g, shape, dtype=torch.float32: torch.empty(shape, device="meta"))
    monkeypatch.setattr(torch, "rand", lambda *shape, generator=None, device=None: torch.empty(*shape, device="meta"))
    mine = PTF.init_params(_MetaGenerator(), p, InitConfig("trunc_normal"), device="meta")
    want_tree = jax.eval_shape(lambda k: JTF.init_params(k, j, JInitConfig("trunc_normal")), jax.random.PRNGKey(0))
    ml, wl = jax.tree_util.tree_flatten_with_path(mine)[0], jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [q for q, _ in ml] == [q for q, _ in wl]
    for (path, g), (_, w) in zip(ml, wl):
        assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    n_el = sum(int(t.numel()) for _, t in ml)
    assert n_el == sum(math.prod(w.shape) for _, w in wl) == ELEMENTS[arch]
    if p.norm == "layernorm":  # n_params counts no final norm, layernorm bias or frontend projector
        assert n_el == want + (2 * p.n_layers + 2) * p.d_model + (p.frontend_embed_dim + 1) * p.d_model


# ------------------------------------------------------------------ decoder
@pytest.fixture(scope="module", params=NEW)
def case(request):
    """(port cfg, numpy params, prompt, embeddings, JAX outputs) for one reduced config."""
    jcfg, pcfg = jbase.get_reduced_config(request.param), pbase.get_reduced_config(request.param)
    params = zoo_params(jcfg, seed=len(request.param))
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    emb = frontend_embeds(jcfg)
    ej = None if emb is None else jnp.asarray(emb)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    hidden, aux = jax.jit(lambda p, t, e: JTF.forward(p, jcfg, t, e, remat=False))(pj, jnp.asarray(prompt), ej)
    logits0, cache = jax.jit(lambda p, t, e: JTF.prefill_cache(p, jcfg, t, CACHE_LEN, frontend_embeds=e))(
        pj, jnp.asarray(prompt), ej)
    want = {"hidden": np.asarray(hidden), "aux": float(aux), "prefill_logits": np.asarray(logits0),
            "prefill_cache": jax.tree_util.tree_map(np.asarray, cache), "steps": []}
    step = jax.jit(JTF.decode_step, static_argnums=1)
    start = hidden.shape[-2]
    tok = np.asarray(logits0).argmax(-1).astype(np.int32)[:, None]
    for i in range(N_DECODE):
        logits, cache = step(pj, jcfg, cache, jnp.asarray(tok), jnp.int32(start + i))
        want["steps"].append((tok, np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache)))
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
    return pcfg, params, prompt, emb, want


def test_parameter_tree_layout_matches_jax(case):
    pcfg, params, _, _, _ = case
    mine = params_to_numpy(PTF.init_params(0, pcfg, InitConfig("trunc_normal", 2.0), device="cpu"))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: (np.shape(a), np.asarray(a).dtype), t)  # noqa: E731
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)
    jshapes = jax.eval_shape(lambda k: JTF.init_params(k, jbase.get_reduced_config(pcfg.name), JInitConfig()),
                             jax.random.PRNGKey(0))
    assert shapes(mine) == jax.tree_util.tree_map(lambda s: (s.shape, np.dtype(s.dtype)), jshapes)
    assert ("frontend_proj" in mine) == bool(pcfg.frontend)
    # the numpy tree converts back leaf for leaf (fp32 leaves stay fp32)
    _assert_tree_close(params_to_numpy(params_from_numpy(params, device="cpu")), params, rtol=0, atol=0)


@pytest.mark.parametrize("arch", NEW)
def test_bf16_tree_converts_leaf_for_leaf(arch):
    """A bf16 model: mamba's ``a_log`` / ``dt_bias`` / ``d_skip`` are its
    only fp32 leaves, the frontend projector is drawn for a frontend
    config; ``params_to_numpy`` carries every leaf, path for path and value
    for value (bf16 as its fp32 values), and back."""
    cfg = dataclasses.replace(pbase.get_reduced_config(arch), dtype="bfloat16")
    p = PTF.init_params(0, cfg, InitConfig("trunc_normal"), device="cpu")
    want = tree_leaves(p)
    fp32 = {path[-1] for path, t in want if t.dtype == torch.float32}
    assert fp32 == ({"a_log", "dt_bias", "d_skip"} if "mamba" in cfg.block_pattern else set())
    assert ("frontend_proj" in p) == bool(cfg.frontend)
    as_np = params_to_numpy(p)
    got = tree_leaves(params_from_numpy(as_np, device="cpu"))
    assert [path for path, _ in got] == [path for path, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert torch.equal(g, w.float()), path


def test_forward_prefill_and_decode_match_jax(case):
    """The frontend embeddings go before the tokens: the hidden states are
    (B, F + S, D) and decoding resumes at F + S."""
    pcfg, params, prompt, emb, want = case
    p = params_from_numpy(params, device="cpu")
    toks, e = torch.as_tensor(prompt), None if emb is None else torch.as_tensor(emb)
    hidden, aux = PTF.forward(p, pcfg, toks, frontend_embeds=e)
    n_front = 0 if emb is None else emb.shape[1]
    assert hidden.shape[-2] == n_front + PROMPT_LEN
    np.testing.assert_allclose(hidden.numpy(), want["hidden"], **TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)
    assert (want["aux"] > 0) == pcfg.is_moe
    logits0, cache = PTF.prefill_cache(p, pcfg, toks, CACHE_LEN, frontend_embeds=e)
    np.testing.assert_allclose(logits0.numpy(), want["prefill_logits"], **TOL)
    _assert_tree_close(params_to_numpy(cache), want["prefill_cache"], **TOL)
    for i, (tok, logits_want, cache_want) in enumerate(want["steps"]):
        logits, cache = PTF.decode_step(p, pcfg, cache, torch.as_tensor(tok), n_front + PROMPT_LEN + i)
        np.testing.assert_allclose(logits.numpy(), logits_want, **TOL)
        _assert_tree_close(params_to_numpy(cache), cache_want, **TOL)


def test_serve_prefill_takes_the_frontend_embeds(case):
    from repro_torch.fed import serve as PS

    pcfg, params, prompt, emb, want = case
    got = PS.prefill(params_from_numpy(params, device="cpu"), pcfg, torch.as_tensor(prompt),
                     None if emb is None else torch.as_tensor(emb))
    np.testing.assert_allclose(got.numpy(), want["prefill_logits"], **TOL)


def test_frontend_projection_promotes_like_the_jax_einsum():
    """fp32 embeddings against bf16 weights: an fp32 product (the JAX
    einsum's promotion), cast to the model's dtype before the tokens."""
    cfg = dataclasses.replace(pbase.get_reduced_config("llava-next-mistral-7b"), dtype="bfloat16")
    p = PTF.init_params(0, cfg, InitConfig("trunc_normal"), device="cpu")
    toks = torch.zeros(1, 3, dtype=torch.int64)
    emb = torch.randn(1, 8, cfg.frontend_embed_dim, generator=torch.Generator().manual_seed(0))
    x = PTF._embed(p, cfg, toks, emb)
    w, b = p["frontend_proj"]["w"].float(), p["frontend_proj"]["b"].float()
    assert x.dtype == torch.bfloat16 and x.shape == (1, 11, cfg.d_model)
    assert torch.equal(x[:, :8], (emb @ w + b).to(torch.bfloat16))
    assert torch.equal(x[:, 8:], p["embed"]["tok"]["w"][toks])
    assert torch.equal(PTF._embed(p, cfg, toks, None), x[:, 8:])


@pytest.mark.parametrize("arch", ["gemma3_4b", "jamba_1p5_large_398b", "rwkv6_3b", "qwen2p5_3b",
                                  "granite_moe_1b_a400m", "musicgen_large", "llava_next_mistral_7b",
                                  "llama4_scout_17b_a16e"])
def test_decode_matches_prefill(arch):
    """The JAX ``test_decode_matches_prefill`` in the port: its init at gain
    2, capacity factor 8 (no MoE token dropped), 24 tokens one at a time
    against one forward pass."""
    cfg = dataclasses.replace(pbase.get_reduced_config(arch), capacity_factor=8.0)
    params = PTF.init_params(1, cfg, InitConfig(gain=2.0), device="cpu")
    b, s = 2, 24
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        hidden, _ = PTF.forward(params, cfg, toks, None, remat=False)
        logits_pre = PTF.hidden_to_logits(params, cfg, hidden)
        cache = PTF.init_cache(cfg, (b,), 64, device="cpu")
        outs = []
        for t in range(s):
            lg, cache = PTF.decode_step(params, cfg, cache, toks[:, t : t + 1], t)
            outs.append(lg[:, 0])
    err = float((logits_pre - torch.stack(outs, 1)).abs().max() / (logits_pre.abs().max() + 1e-9))
    assert err < 5e-4, err


# ------------------------------------------------------------------ RWKV training
def test_rwkv_node_loss_gradient_matches_jax(monkeypatch):
    """lm_loss of the reduced rwkv6-3b and its gradient, the recorded
    time-mix through the plain chunked form (a ragged L = 45: the ones-padded
    last chunk), against ``jax.value_and_grad`` of the JAX loss; the kernel
    wrapper is not called while autograd records."""
    from repro_torch.kernels.rwkv import ops as rwkv_ops

    jcfg, pcfg = jbase.get_reduced_config("rwkv6-3b"), pbase.get_reduced_config("rwkv6-3b")
    params = rwkv_numpy_params(jcfg, seed=13)
    rng = np.random.default_rng(14)
    x = rng.integers(0, jcfg.vocab_size, (2, 45)).astype(np.int32)
    y = rng.integers(0, jcfg.vocab_size, (2, 45)).astype(np.int32)

    def jax_loss(p):
        hidden, aux = JTF.forward(p, jcfg, jnp.asarray(x))
        return JTF.lm_loss(p, jcfg, hidden, jnp.asarray(y)) + 0.01 * aux

    lj, gj = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, params))
    calls = []
    real = rwkv_ops.rwkv6_chunked
    monkeypatch.setattr(rwkv_ops, "rwkv6_chunked", lambda *a: calls.append(1) or real(*a))
    pt = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(params, device="cpu"))
    hidden, aux = PTF.forward(pt, pcfg, torch.as_tensor(x))
    loss = PTF.lm_loss(pt, pcfg, hidden, torch.as_tensor(y)) + PTF.AUX_WEIGHT * aux
    loss.backward()
    assert calls == []
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    grads, want = [t.grad for _, t in tree_leaves(pt)], jax.tree_util.tree_leaves(gj)
    assert len(grads) == len(want) and all(g is not None for g in grads)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)
    with torch.no_grad():
        PTF.forward(params_from_numpy(params, device="cpu"), pcfg, torch.as_tensor(x))
    assert len(calls) == pcfg.n_layers  # no grad: the kernel's wrapper, every layer


def _jax_train_loop(arch, params, rounds, batch_size, seed=0):
    """The JAX CLI's --arch path (``repro/launch/train.py``): its loss, SGD
    (1e-3, 0.5) on the complete graph, token streams of 20,000 a node,
    windows of 64, from the given node-stacked params."""
    from repro.core import topology as JT
    from repro.data import make_token_stream, token_batch_iterator
    from repro.fed import make_round_fn, train_loop
    from repro.fed.trainer import DFLState
    from repro.optim import sgd

    jcfg = jbase.get_reduced_config(arch)
    n = jax.tree_util.tree_leaves(params)[0].shape[0]
    toks = np.stack([make_token_stream(20_000, jcfg.vocab_size, seed=seed + i) for i in range(n)])
    it = token_batch_iterator(toks, batch_size=batch_size, seq_len=64, seed=seed)

    def loss_fn(p, batch):
        hidden, aux = JTF.forward(p, jcfg, batch[0])
        return JTF.lm_loss(p, jcfg, hidden, batch[1]) + 0.01 * aux

    def batches():
        while True:
            b = next(it)
            yield b.x[:, None], b.y[:, None]

    opt = sgd(1e-3, 0.5)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = DFLState(params=p, opt_state=jax.vmap(opt.init)(p), round=jnp.zeros((), jnp.int32),
                     rng=jax.random.PRNGKey(seed))
    _, hist = train_loop(state, make_round_fn(loss_fn, opt, JT.complete(n)), batches(), n_rounds=rounds,
                         eval_every=1, track_sigmas=True)
    return hist


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b", "llava-next-mistral-7b"])
def test_arch_cli_matches_the_jax_train_loop(arch, monkeypatch, capsys):
    """``--arch <config> --reduced`` on the CPU from injected params, 2
    rounds at 2 nodes: the train losses and σ metrics of the JAX
    ``train_loop`` on the same params and batches, to rtol 1e-4."""
    jcfg = jbase.get_reduced_config(arch)
    params = (rwkv_numpy_params if arch == "rwkv6-3b" else zoo_params)(jcfg, seed=21, n_nodes=2)
    monkeypatch.setattr(p_cli, "init_fl_state", lambda seed, n, init_one, opt, gains=None, device=None:
                        state_from_numpy(params, optimizer=opt, device=device))
    hist = p_cli.main(["--arch", arch, "--reduced", "--nodes", "2", "--rounds", "2", "--local-batches", "1",
                       "--batch-size", "2", "--device", "cpu"])
    assert "round    1 train" in capsys.readouterr().out
    want = _jax_train_loop(arch, params, rounds=2, batch_size=2)
    assert hist["round"] == want["round"] == [0, 1]
    for key in ("train_loss", "sigma_ap", "sigma_an"):
        np.testing.assert_allclose(hist[key], want[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("argv", [
    ["--model", "rwkv"],
    ["--model", "rwkv", "--compress", "int8"],
    ["--arch", "musicgen-large", "--reduced"],
    ["--arch", "llama4-scout-17b-a16e", "--reduced"],
])
def test_new_cli_paths_run(argv, capsys):
    """``--model rwkv`` through the executor (token windows, recorded rounds
    through the plain chunked time-mix, each round's eval through the
    kernel's wrapper) and the other new ``--arch`` configs host-fed: 2
    rounds, finite losses."""
    common = ["--nodes", "2", "--rounds", "2", "--local-batches", "1", "--batch-size", "2", "--device", "cpu"]
    if argv[0] == "--model":
        common += ["--items-per-node", "8", "--seq-len", "16"]
    hist = p_cli.main([*argv, *common])
    out = capsys.readouterr().out
    assert hist["round"] == [0, 1] and np.isfinite(hist["train_loss"]).all()
    if argv[0] == "--model":
        assert "token model rwkv6-3b:" in out and "seq 16" in out
        assert np.isfinite(hist["test_loss"]).all() and hist["wire_messages"] == [2, 2]
    else:
        assert "round    1 train" in out and hist["test_loss"] == []
