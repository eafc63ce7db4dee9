"""DecAvg training of the paper's CNN (cfg B): one and three rounds through
the port's ``make_round_fn`` / ``run_trajectory`` against the JAX package's
``run_trajectory`` from one injected state (a numpy-seeded He draw, held as
a JAX ``DFLState`` whose leaves go through ``state_from_numpy``), the same
So2Sat-like data under a Zipf α = 1.8 split and the same batch schedule, on
BA(4, m=2).  History to rtol 1e-4 / atol 1e-5, final parameters to rtol
1e-4 / atol 1e-5 · max|leaf| — not bitwise: the two frameworks sum in
different orders.

One round runs the gain-corrected init (gain 1.98), three the uncorrected
He init: at the corrected gain the first losses are ~47 and softmax
saturation amplifies the fp32 summation-order differences, which reach
1.7e-4 · max|leaf| (conv2's weights) by round 3; at gain 1 all leaves stay
within 2e-7 · max|leaf| (the same property as the MLP ring case of
``test_torch_trainer.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import fed as JF  # noqa: E402
from repro import optim as JO  # noqa: E402
from repro.core import commplan as JC  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.core.initialisation import gain_from_graph  # noqa: E402
from repro.data import batch_index_schedule, node_datasets, partition_zipf, so2sat_like  # noqa: E402
from repro.models import paper_models as JPM  # noqa: E402
from repro_torch import fed as PF  # noqa: E402
from repro_torch import optim as PO  # noqa: E402
from repro_torch.convert import state_from_numpy, to_numpy  # noqa: E402
from repro_torch.core import commplan as PC  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import paper_models as PPM  # noqa: E402

N, PER_NODE, BS, B_LOCAL = 4, 16, 4, 2
KEYS = ("train_loss", "test_loss", "sigma_ap", "sigma_an")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU products run fastest on one thread here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_loss(p, b):
    return JPM.classifier_loss(JPM.cnn_forward(p, b[0]), b[1])


def torch_loss(p, b):
    return PPM.classifier_loss(PPM.cnn_forward(p, b[0]), b[1])


def _injected_state(gain, opt_j):
    """He normal at ``gain`` drawn with numpy in the JAX layout (zero
    biases), with the JAX package's own optimizer init."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: JPM.init_cnn(JInitConfig(), k), jax.random.PRNGKey(0))

    def leaf(s):
        if len(s.shape) == 1:
            return jnp.zeros((N, *s.shape), jnp.float32)
        std = math.sqrt(2.0 / math.prod(s.shape[:-1])) * gain
        return jnp.asarray((rng.standard_normal((N, *s.shape)) * std).astype(np.float32))

    params = jax.tree_util.tree_map(leaf, shapes)
    return JF.DFLState(
        params=params, opt_state=jax.vmap(opt_j.init)(params), round=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0),
    )


@pytest.fixture(scope="module", params=[(1, True), (3, False)],
                ids=lambda c: f"{c[0]}round-{'corrected' if c[1] else 'he'}")
def both_runs(request):
    rounds, corrected = request.param
    gj, gp = JT.barabasi_albert(N, 2, seed=0), PT.barabasi_albert(N, 2, seed=0)
    np.testing.assert_array_equal(gj.adjacency, gp.adjacency)
    opt_j, opt_t = JO.sgd(1e-3, 0.5), PO.sgd(1e-3, 0.5)
    ds = so2sat_like(N * PER_NODE + 32, seed=0)
    xs, ys = node_datasets(ds, partition_zipf(ds.y[: N * PER_NODE], N, alpha=1.8, seed=0))
    test = (ds.x[-32:], ds.y[-32:])
    sched = batch_index_schedule(xs.shape[1], N, BS, rounds * B_LOCAL, seed=0)
    common = dict(n_rounds=rounds, eval_every=1, eval_batch=test, track_sigmas=True, b_local=B_LOCAL)
    s_j = _injected_state(gain_from_graph(gj) if corrected else 1.0, opt_j)
    rf_j = JF.make_round_fn(jax_loss, opt_j, JC.compile_plan(gj, "dense"))
    fin_j, h_j = JF.run_trajectory(s_j, rf_j, xs, ys, sched, eval_fn=JF.make_eval_fn(jax_loss), **common)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    s_t = state_from_numpy(to_np(s_j.params), to_np(s_j.opt_state), device="cpu")
    rf_t = PF.make_round_fn(torch_loss, opt_t, PC.compile_plan(gp, "dense", device="cpu"))
    fin_t, h_t = PF.run_trajectory(s_t, rf_t, xs, ys, sched, eval_fn=PF.make_eval_fn(torch_loss), device="cpu",
                                   **common)
    return rounds, (to_np(fin_j.params), h_j), (fin_t, h_t)


def test_cnn_trajectory_matches_jax(both_runs):
    rounds, (params_j, h_j), (fin_t, h_t) = both_runs
    assert h_t["round"] == h_j["round"] == list(range(rounds))
    for k in KEYS:
        np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    params_t, _ = to_numpy(fin_t)
    for layer in params_j:
        for leaf in ("w", "b"):
            want = params_j[layer][leaf]
            np.testing.assert_allclose(params_t[layer][leaf], want, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(want).max()), err_msg=f"{layer}/{leaf}")
    assert fin_t.round == rounds


@pytest.mark.parametrize("argv", [["--model", "cnn"], ["--model", "vgg16", "--zipf", "1.8"]],
                         ids=["cnn", "vgg16-zipf"])
def test_cli_trains_the_conv_nets_on_cpu(argv, capsys):
    hist = cli.main([
        *argv, "--device", "cpu", "--nodes", "2", "--rounds", "1", "--items-per-node", "32", "--local-batches", "1",
    ])
    assert hist["round"] == [0]
    assert all(np.isfinite(hist[k]).all() for k in KEYS)
    assert hist["wire_messages"] == [2]
    out = capsys.readouterr().out
    assert "gain=1.41" in out and "dense backend on cpu" in out
