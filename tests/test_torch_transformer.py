"""The port's decoder (configs, norms, RoPE, FFNs, forward, prefill and
decode) against the JAX package's on the same numpy-seeded parameters.

Parameters are drawn once with numpy in the JAX package's tree layout (leaf
paths and shapes from ``jax.eval_shape`` of its ``init_params``) and
injected into both packages; the JAX outputs come from jitted calls in
module-scoped fixtures.  fp32 throughout: forward hidden states, prefill
logits, every cache leaf and four decode steps to rtol 1e-4, atol 1e-5
(the two frameworks sum the same products in other orders).  The port's
own initialiser is held in distribution: std within 2% of the per-layer
fan-in rule, truncation at ±2σ.
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
from repro.models import common as JC  # noqa: E402
from repro.models import mlp as JMLP  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core.initialisation import InitConfig  # noqa: E402
from repro_torch.flat import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import common as PC  # noqa: E402
from repro_torch.models import mlp as PMLP  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen2p5_3b", "gemma3_4b", "granite_moe_1b_a400m", "stablelm_12b", "qwen1p5_4b"]


def config_pair(arch: str, **changes):
    """The same reduced configuration in both packages."""
    j = dataclasses.replace(jbase.get_reduced_config(arch), **changes)
    p = dataclasses.replace(pbase.get_reduced_config(arch), **changes)
    return j, p


def swa_changes(window: int) -> dict:
    """The fields ``qwen2p5_3b.swa_variant(window)`` changes, from the JAX package's."""
    from repro.configs import qwen2p5_3b as JQ

    full, swa = dataclasses.asdict(JQ.CONFIG), dataclasses.asdict(JQ.swa_variant(window))
    return {f: v for f, v in swa.items() if v != full[f] and f != "max_seq_len"}


# reduced qwen; reduced gemma at S > window; a gemma variant whose 7 layers
# make 3 periods (the JAX package scans) and one tail layer; reduced
# granite-moe (a MoE FFN at every layer: E 4, top 2), stablelm-12b
# (layernorm, hd 40), qwen1.5-4b (qkv bias, MHA, hd 30); the swa variant of
# qwen2.5-3b on the reduced width with a window of 16 < S
CONFIGS = {
    "qwen": ("qwen2p5_3b", {}),
    "gemma": ("gemma3_4b", {}),
    "gemma_tail": ("gemma3_4b", {"n_layers": 7}),
    "granite": ("granite_moe_1b_a400m", {}),
    "stablelm": ("stablelm_12b", {}),
    "qwen15": ("qwen1p5_4b", {}),
    "qwen_swa": ("qwen2p5_3b", swa_changes(16)),
}
PROMPT_LEN, CACHE_LEN, N_DECODE = 40, 64, 4


def numpy_params(jcfg, seed: int = 0, n_nodes: int | None = None, gain: float = 1.0):
    """A numpy parameter tree in the JAX package's layout: weights normal ×
    gain / √fan_in (per-layer fan), biases and norm scales perturbed so
    every leaf matters; with ``n_nodes`` every leaf gets a node axis.

    At gain 1 the port and JAX agree to ~2e-6 on logits of ~2; gain 2
    through seven layers amplifies the summation-order drift to ~1e-5 on
    logits of ~3, the effect ROADMAP Queue 3 records for the MLP."""
    shapes = jax.eval_shape(lambda k: JTF.init_params(k, jcfg, JInitConfig("trunc_normal")), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    lead = (n_nodes,) if n_nodes else ()

    def draw(path, s):
        name, shape = path[-1].key, lead + s.shape
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("b", "bias"):  # a dense bias, a layernorm's
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) * gain / math.sqrt(s.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _assert_tree_close(got, want, **tol):
    gl, wl = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path), **tol)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for getter in ("get_config", "get_reduced_config"):
        j, p = getattr(jbase, getter)(arch), getattr(pbase, getter)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert p.n_params() == j.n_params()
        assert p.n_active_params() == j.n_active_params()
        assert pbase.layer_kinds(p) == jbase.layer_kinds(j)
        assert pbase.ffn_kinds(p) == jbase.ffn_kinds(j)
        assert PTF.unit_size(p) == JTF.unit_size(j)
        assert PTF._split_layers(p) == JTF._split_layers(j)
    assert pbase.get_config(arch).param_dtype == torch.bfloat16
    assert pbase.get_reduced_config(arch).param_dtype == torch.float32


def test_full_width_parameter_counts():
    assert pbase.get_config("qwen2.5-3b").n_params() == 3_085_936_640
    assert pbase.get_config("gemma3-4b").n_params() == 3_879_905_280
    assert PTF._split_layers(pbase.get_config("gemma3-4b")) == (6, 5, 4)
    granite = pbase.get_config("granite-moe-1b-a400m")
    assert (granite.n_params(), granite.n_active_params()) == (1_334_627_328, 428_657_664)
    assert pbase.get_config("stablelm-12b").n_params() == 12_142_919_680
    assert pbase.get_config("qwen1.5-4b").n_params() == 3_950_366_720


def test_swa_variant_matches_jax():
    from repro.configs import qwen2p5_3b as JQ
    from repro_torch.configs import qwen2p5_3b as PQ

    for window in (8192, 16):
        j, p = JQ.swa_variant(window), PQ.swa_variant(window)
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert pbase.layer_kinds(p) == ["swa"] * p.n_layers and p.sliding_window == window
        assert PTF._split_layers(p) == JTF._split_layers(j)
    assert PQ.swa_variant().sliding_window == 8192


def test_registry_names_what_is_not_ported():
    """Every zoo architecture resolves (the list the JAX package's), a
    mamba stack and a vision frontend initialise, an unknown arch or block
    kind raises."""
    assert pbase.list_archs() == jbase.list_archs() and len(pbase.list_archs()) == 10
    assert pbase.get_config("rwkv6-3b").block_pattern == ("rwkv",)
    assert pbase.layer_kinds(pbase.get_config("jamba-1.5-large-398b"))[:8] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert pbase.get_config("llava-next-mistral-7b").frontend == "vision"
    with pytest.raises(ValueError, match="unknown"):
        pbase.get_config("gpt-9")
    mamba = dataclasses.replace(pbase.get_reduced_config("qwen2.5-3b"), block_pattern=("mamba",))
    assert "mamba" in PTF.init_params(0, mamba, InitConfig(), device="cpu")["stack"][0]
    vision = dataclasses.replace(pbase.get_reduced_config("qwen2.5-3b"), frontend="vision", n_frontend_tokens=8,
                                 frontend_embed_dim=32)
    assert PTF.init_params(0, vision, InitConfig(), device="cpu")["frontend_proj"]["w"].shape == (32, 128)
    with pytest.raises(ValueError, match="unknown block kind"):
        PTF.init_params(0, dataclasses.replace(mamba, block_pattern=("conv",)), InitConfig(), device="cpu")


# ------------------------------------------------------------------ blocks
def test_norm_rope_and_ffn_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(128)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(128)).astype(np.float32)}
    pt, pj = tree_map(torch.as_tensor, p), tree_map(jnp.asarray, p)
    for kind in ("rmsnorm", "layernorm"):
        np.testing.assert_allclose(
            PC.norm_apply(pt, torch.as_tensor(x), kind).numpy(),
            np.asarray(JC.norm_apply(pj, jnp.asarray(x), kind)), atol=1e-5, rtol=1e-5,
        )
    q = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(100, 109)
    np.testing.assert_allclose(
        PC.apply_rope(torch.as_tensor(q), torch.as_tensor(pos), 1e6).numpy(),
        np.asarray(JC.apply_rope(jnp.asarray(q), jnp.asarray(pos), 1e6)), atol=1e-5, rtol=1e-5,
    )
    np.testing.assert_allclose(PC.rope_freqs(32, 1e6).numpy(), np.asarray(JC.rope_freqs(32, 1e6)), rtol=1e-6)
    # SwiGLU (qwen), GeGLU with the tanh GELU (gemma), the plain GELU MLP
    for arch, changes in (("qwen2p5_3b", {}), ("gemma3_4b", {}), ("gemma3_4b", {"mlp_type": "gelu_mlp"})):
        jcfg, pcfg = config_pair(arch, **changes)
        w = {k: {"w": (rng.standard_normal(s) / math.sqrt(s[0])).astype(np.float32)}
             for k, s in (("w_gate", (128, 256)), ("w_in", (128, 256)), ("w_out", (256, 128)))}
        shapes = jax.tree_util.tree_map(np.shape, jax.eval_shape(lambda k: JMLP.init_ffn(JInitConfig(), k, jcfg),
                                                                 jax.random.PRNGKey(0)))
        w = {k: v for k, v in w.items() if k in shapes}
        assert shapes == tree_map(np.shape, PMLP.init_ffn(InitConfig(), _g(0), pcfg))
        np.testing.assert_allclose(
            PMLP.ffn_forward(tree_map(torch.as_tensor, w), pcfg, torch.as_tensor(x)).numpy(),
            np.asarray(JMLP.ffn_forward(tree_map(jnp.asarray, w), jcfg, jnp.asarray(x))), atol=1e-5, rtol=1e-4,
        )


# ------------------------------------------------------------------ decoder
@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """(port cfg, numpy params, prompt, JAX outputs) for one configuration."""
    arch, changes = CONFIGS[request.param]
    jcfg, pcfg = config_pair(arch, **changes)
    params = numpy_params(jcfg, seed=len(request.param))
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, PROMPT_LEN)).astype(np.int32)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    hidden, aux = jax.jit(JTF.forward, static_argnums=1)(pj, jcfg, jnp.asarray(prompt))
    logits0, cache = jax.jit(JTF.prefill_cache, static_argnums=(1, 3))(pj, jcfg, jnp.asarray(prompt), CACHE_LEN)
    want = {"hidden": np.asarray(hidden), "aux": float(aux), "prefill_logits": np.asarray(logits0),
            "prefill_cache": jax.tree_util.tree_map(np.asarray, cache), "steps": []}
    step = jax.jit(JTF.decode_step, static_argnums=1)
    tok = np.asarray(logits0).argmax(-1).astype(np.int32)[:, None]
    for i in range(N_DECODE):
        logits, cache = step(pj, jcfg, cache, jnp.asarray(tok), jnp.int32(PROMPT_LEN + i))
        want["steps"].append((tok, np.asarray(logits), jax.tree_util.tree_map(np.asarray, cache)))
        tok = np.asarray(logits)[:, -1].argmax(-1).astype(np.int32)[:, None]
    return pcfg, params, prompt, want


def test_parameter_tree_layout_matches_jax(case):
    pcfg, params, _, _ = case
    mine = params_to_numpy(PTF.init_params(0, pcfg, InitConfig("trunc_normal", 2.0), device="cpu"))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)  # noqa: E731
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)
    assert shapes(mine) == shapes(params)
    n = sum(a.size for a in jax.tree_util.tree_leaves(mine))
    # n_params leaves out the final norm and counts a norm's scale only (no layernorm bias)
    n_norms = 2 * pcfg.n_layers + 1
    assert n == pcfg.n_params() + pcfg.d_model + (n_norms * pcfg.d_model if pcfg.norm == "layernorm" else 0)


def test_forward_prefill_and_decode_match_jax(case):
    pcfg, params, prompt, want = case
    p = params_from_numpy(params, device="cpu")
    toks = torch.as_tensor(prompt)
    hidden, aux = PTF.forward(p, pcfg, toks)
    np.testing.assert_allclose(hidden.numpy(), want["hidden"], **TOL)
    # the MoE aux summed over the layers (0 without a MoE FFN, in both packages)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)
    assert (want["aux"] > 0) == pcfg.is_moe
    logits0, cache = PTF.prefill_cache(p, pcfg, toks, CACHE_LEN)
    np.testing.assert_allclose(logits0.numpy(), want["prefill_logits"], **TOL)
    _assert_tree_close(params_to_numpy(cache), want["prefill_cache"], **TOL)
    for i, (tok, logits_want, cache_want) in enumerate(want["steps"]):
        logits, cache = PTF.decode_step(p, pcfg, cache, torch.as_tensor(tok), PROMPT_LEN + i)
        np.testing.assert_allclose(logits.numpy(), logits_want, **TOL)
        _assert_tree_close(params_to_numpy(cache), cache_want, **TOL)


def test_bf16_parameters_convert_exactly():
    """bf16 jax arrays reach numpy as ml_dtypes' bfloat16 and the port as bf16."""
    a = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    got = params_from_numpy({"stack": [{"w": np.asarray(a)}]}, device="cpu")["stack"][0]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": got})["w"], np.asarray(a, np.float32))


def test_swa_cache_is_a_ring_of_the_window(case):
    pcfg, params, prompt, _ = case
    cache = PTF.init_cache(pcfg, (2,), CACHE_LEN, device="cpu")
    for kind, c in zip(pbase.layer_kinds(pcfg), cache["stack"]):
        want_t = min(pcfg.sliding_window, CACHE_LEN) if kind == "swa" else CACHE_LEN
        assert c["k"].shape[-3] == want_t


# ------------------------------------------------------------------ init
def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def test_init_statistics_follow_the_per_layer_fan_in():
    """trunc_normal(±2σ) × gain / √fan_in, fans from the per-layer shape (a
    stacked (periods, d, f) leaf is not a conv) and the vocabulary for the
    embedding; per-node gains scale each node's draw."""
    cfg = dataclasses.replace(pbase.get_reduced_config("qwen2.5-3b"), n_layers=4, d_model=256, d_ff=512)
    gains = torch.tensor([1.0, 3.0])
    p = PTF.init_params(_g(7), cfg, InitConfig("trunc_normal", gains), device="cpu")
    trunc_std = 0.87962566  # std of N(0, 1) truncated at ±2
    leaves = {
        "w_gate": (p["stack"][0]["ffn"]["w_gate"]["w"], 256),
        "w_out": (p["stack"][0]["ffn"]["w_out"]["w"], 512),
        "wq": (p["stack"][0]["attn"]["wq"]["w"], 256),
        "embed": (p["embed"]["tok"]["w"], cfg.vocab_size),
    }
    assert p["stack"][0]["ffn"]["w_gate"]["w"].shape == (2, 4, 256, 512)
    for name, (w, fan_in) in leaves.items():
        for node, gain in enumerate(gains.tolist()):
            s = gain / math.sqrt(fan_in)
            x = w[node]
            assert abs(float(x.std()) / (trunc_std * s) - 1) < 0.02, name
            assert float(x.abs().max()) <= 2 * s * (1 + 1e-6), name
            assert float(x.abs().max()) > 1.9 * s, name
    # periods and nodes draw independently; norms ones, biases zeros
    w = p["stack"][0]["ffn"]["w_gate"]["w"]
    assert abs(float(torch.corrcoef(torch.stack([w[0, 0].flatten(), w[0, 1].flatten()]))[0, 1])) < 0.02
    assert abs(float(torch.corrcoef(torch.stack([w[0, 0].flatten(), w[1, 0].flatten()]))[0, 1])) < 0.02
    assert float(p["final_norm"]["scale"].min()) == 1.0 and p["final_norm"]["scale"].shape == (2, 256)
    assert float(p["stack"][0]["attn"]["wq"]["b"].abs().max()) == 0.0
    # a scalar gain gives one parameter set on the generator's device
    single = PTF.init_params(_g(1), cfg, InitConfig("trunc_normal", 2.0), device="cpu")
    assert single["embed"]["tok"]["w"].shape == (cfg.vocab_size, 256)


# ------------------------------------------------- the JAX calls' keywords
@pytest.fixture(scope="module")
def keyword_case():
    """The 7-layer gemma variant (3 periods and a tail layer), with a
    frontend embedding the config ignores (it has no frontend), and the JAX
    outputs of ``forward(..., frontend_embeds=, remat=)`` and
    ``serve.prefill(..., frontend_embeds=)``."""
    from repro.fed import serve as JS

    arch, changes = CONFIGS["gemma_tail"]
    jcfg, pcfg = config_pair(arch, **changes)
    params = numpy_params(jcfg, seed=5)
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    emb = np.random.default_rng(6).standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    args = (pj, jnp.asarray(prompt), jnp.asarray(emb))
    want = {
        remat: np.asarray(jax.jit(lambda p, t, e, r=remat: JTF.forward(p, jcfg, t, frontend_embeds=e, remat=r)[0])(*args))
        for remat in (True, False)
    }
    want["prefill"] = np.asarray(jax.jit(lambda p, t, e: JS.prefill(p, jcfg, t, frontend_embeds=e))(*args))
    return pcfg, params, prompt, emb, want


@pytest.mark.parametrize("remat", [True, False])
def test_forward_keywords_match_jax(keyword_case, remat):
    """forward(frontend_embeds=, remat=) as the JAX call, recorded by
    autograd (remat=True recomputes each period in the backward pass)."""
    pcfg, params, prompt, emb, want = keyword_case
    p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params, device="cpu"))
    hidden, aux = PTF.forward(p, pcfg, torch.as_tensor(prompt), frontend_embeds=torch.as_tensor(emb), remat=remat)
    assert hidden.requires_grad and float(aux) == 0.0
    np.testing.assert_allclose(hidden.detach().numpy(), want[remat], **TOL)


def test_prefill_frontend_embeds_matches_jax(keyword_case):
    from repro_torch.fed import serve as PS

    pcfg, params, prompt, emb, want = keyword_case
    got = PS.prefill(params_from_numpy(params, device="cpu"), pcfg, torch.as_tensor(prompt),
                     frontend_embeds=torch.as_tensor(emb))
    np.testing.assert_allclose(got.numpy(), want["prefill"], **TOL)


def test_remat_gradients_equal_the_plain_ones(keyword_case):
    """The recomputed periods give the gradients of the stored ones, bit for
    bit (the same operations in the same order, on the CPU)."""
    pcfg, params, prompt, _, _ = keyword_case
    toks = torch.as_tensor(prompt)
    grads = {}
    for remat in (True, False):
        p = tree_map(lambda t: t.requires_grad_(), params_from_numpy(params, device="cpu"))
        hidden, _ = PTF.forward(p, pcfg, toks[:, :-1], remat=remat)
        loss = PTF.lm_loss(p, pcfg, hidden, toks[:, 1:])
        grads[remat] = torch.autograd.grad(loss, [t for _, t in tree_leaves(p)])
    assert len(grads[True]) == len(grads[False]) > 0
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
