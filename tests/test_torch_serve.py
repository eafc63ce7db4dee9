"""The port's offline serving against the JAX package's, on the CPU.

Greedy ``generate`` must emit exactly the JAX package's tokens on the same
numpy-seeded parameters (reduced qwen2.5-3b, and reduced gemma3-4b with a
prompt past its window); ``consensus_params`` agrees leaf for leaf (fp32,
1e-6); within the port, the prefill path equals the token-wise reference
loop, ``ServeEngine.serve`` equals per-node ``generate``, and temperature
sampling is reproducible for a given generator (JAX's threefry draws are
not reproduced, so it is held for determinism and range only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fed import serve as JS  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.fed import serve as PS  # noqa: E402
from repro_torch.flat import tree_map  # noqa: E402
from test_torch_transformer import config_pair, numpy_params  # noqa: E402

N_NEW, CACHE_LEN, N_NODES = 6, 64, 3
PROMPT_LEN = {"qwen2p5_3b": 12, "gemma3_4b": 40}  # gemma: past its window of 16


@pytest.fixture(scope="module", params=["qwen2p5_3b", "gemma3_4b"])
def served(request):
    """Port cfg, node-stacked numpy params, prompts, and the JAX package's
    consensus, greedy tokens from the consensus and from each node."""
    arch = request.param
    jcfg, pcfg = config_pair(arch)
    nodes = numpy_params(jcfg, seed=11, n_nodes=N_NODES)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, PROMPT_LEN[arch])).astype(np.int32)
    nj = jax.tree_util.tree_map(jnp.asarray, nodes)
    cons = JS.consensus_params(nj)
    want = {
        "consensus": jax.tree_util.tree_map(np.asarray, cons),
        "weighted": jax.tree_util.tree_map(np.asarray, JS.consensus_params(nj, jnp.asarray([1.0, 2.0, 5.0]))),
        "tokens": np.asarray(JS.generate(cons, jcfg, jnp.asarray(prompt), N_NEW, CACHE_LEN)),
        "node_tokens": np.asarray(
            JS.ServeEngine(jcfg, CACHE_LEN).serve(nj, jnp.asarray([2, 0]), jnp.asarray(prompt), N_NEW)
        ),
    }
    return pcfg, nodes, prompt, want


def _close_trees(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(params_to_numpy(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_consensus_matches_jax(served):
    pcfg, nodes, _, want = served
    p = params_from_numpy(nodes, device="cpu")
    _close_trees(PS.consensus_params(p), want["consensus"])
    _close_trees(PS.consensus_params(p, np.asarray([1.0, 2.0, 5.0])), want["weighted"])
    # averaging reads the ensemble and never writes it
    for got, orig in zip(jax.tree_util.tree_leaves(params_to_numpy(p)), jax.tree_util.tree_leaves(nodes)):
        np.testing.assert_array_equal(got, orig)


def test_greedy_generate_emits_the_jax_tokens(served):
    pcfg, nodes, prompt, want = served
    cons = PS.consensus_params(params_from_numpy(nodes, device="cpu"))
    got = PS.generate(cons, pcfg, prompt, N_NEW, CACHE_LEN, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, N_NEW)
    np.testing.assert_array_equal(got.numpy(), want["tokens"])
    engine = PS.ServeEngine(pcfg, CACHE_LEN, device="cpu")
    np.testing.assert_array_equal(engine.generate(cons, prompt, N_NEW).numpy(), want["tokens"])
    # the first token is the argmax of the full-sequence prefill
    np.testing.assert_array_equal(
        PS.prefill(cons, pcfg, torch.as_tensor(prompt)).argmax(-1).numpy(), want["tokens"][:, 0]
    )


def test_serve_answers_from_the_assigned_nodes(served):
    pcfg, nodes, prompt, want = served
    p = params_from_numpy(nodes, device="cpu")
    engine = PS.ServeEngine(pcfg, CACHE_LEN, device="cpu")
    got = engine.serve(p, [2, 0], prompt, N_NEW)
    np.testing.assert_array_equal(got.numpy(), want["node_tokens"])
    for i, node in enumerate((2, 0)):
        one = tree_map(lambda leaf: leaf[node], p)
        single = PS.generate(one, pcfg, prompt[i : i + 1], N_NEW, CACHE_LEN, device="cpu")
        np.testing.assert_array_equal(got[i].numpy(), single[0].numpy())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_prefill_path_equals_tokenwise_loop(served, temperature):
    pcfg, nodes, prompt, _ = served
    cons = PS.consensus_params(params_from_numpy(nodes, device="cpu"))
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    fast = PS.generate(cons, pcfg, prompt, N_NEW, CACHE_LEN, temperature, gen(), device="cpu")
    slow = PS.generate_tokenwise(cons, pcfg, prompt, N_NEW, CACHE_LEN, temperature, gen(), device="cpu")
    np.testing.assert_array_equal(fast.numpy(), slow.numpy())


def test_temperature_sampling_is_reproducible(served):
    pcfg, nodes, prompt, want = served
    cons = PS.consensus_params(params_from_numpy(nodes, device="cpu"))
    draws = [
        PS.generate(cons, pcfg, prompt, 16, CACHE_LEN, 2.0, torch.Generator().manual_seed(seed), device="cpu")
        for seed in (3, 3, 4)
    ]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    assert not np.array_equal(draws[0].numpy(), draws[2].numpy())
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < pcfg.vocab_size
    # sampling at a high temperature leaves the greedy path
    assert not np.array_equal(draws[0][:, :N_NEW].numpy(), want["tokens"])


@pytest.mark.parametrize("vocab", [97, 1024, 151936])
def test_token_stream_is_bitwise_the_jax_packages(vocab):
    """The prompts: a numpy copy, so the same seed gives the same tokens
    (151936 exercises the scatter of 1024 states into a large vocabulary)."""
    from repro.data.synthetic import make_token_stream as jax_stream
    from repro_torch.data import make_token_stream

    for seed in (0, 7):
        got = make_token_stream(500, vocab, seed=seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jax_stream(500, vocab, seed=seed))
