"""PyTorch port: the wall-clock timers of ``utils/benchmark`` (the JAX
package's ``time_fn`` and ``time_fn_pipelined``) on the CPU, where they
are host times: each counts its calls (warmup + iters; warmup + reps *
iters), returns a best no larger than its median, passes the arguments
through, and takes its device from the first tensor argument or from
``device``; without either it asks for the card, which raises here."""
import pytest

torch = pytest.importorskip("torch")

from gta_graph_tensor_acclelrator_for_general_gnn_tpu_torch.utils import benchmark as B  # noqa: E402

CPU = "cpu"


class Counter:
    def __init__(self):
        self.calls = 0
        self.seen = []

    def __call__(self, *args, **kwargs):
        self.calls += 1
        self.seen.append((args, kwargs))
        return torch.ones(4) * self.calls


@pytest.mark.parametrize("iters,warmup", [(1, 0), (5, 2), (50, 2)])
def test_time_fn_counts_calls(iters, warmup):
    fn = Counter()
    x = torch.zeros(3)
    med, best = B.time_fn(fn, x, scale=2.0, iters=iters, warmup=warmup)
    assert fn.calls == warmup + iters
    assert all(a == (x,) and k == {"scale": 2.0} for a, k in fn.seen)
    assert 0.0 <= best <= med


@pytest.mark.parametrize("iters,warmup,reps", [(1, 0, 1), (10, 5, 3),
                                               (100, 5, 5)])
def test_time_fn_pipelined_counts_calls(iters, warmup, reps):
    fn = Counter()
    s = B.time_fn_pipelined(fn, iters=iters, warmup=warmup, reps=reps,
                            device=CPU)
    assert fn.calls == warmup + reps * iters
    assert s >= 0.0


def test_time_fn_best_below_median_on_work():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    med, best = B.time_fn(torch.mm, a, a, iters=11)
    assert 0.0 < best <= med
    per_call = B.time_fn_pipelined(torch.mm, a, a, iters=20, reps=3)
    assert per_call > 0.0


def test_timer_device():
    x = torch.zeros(2)
    assert B._timer_device((1, x), {}, None) == torch.device(CPU)
    assert B._timer_device((), {"x": x}, None) == torch.device(CPU)
    assert B._timer_device((), {}, CPU) == torch.device(CPU)
    if not torch.cuda.is_available():
        # no tensor and no device: the card, which this host lacks
        with pytest.raises(RuntimeError):
            B.time_fn(lambda: None, iters=1)
        with pytest.raises(RuntimeError):
            B.time_fn_pipelined(lambda: None, iters=1)
