"""``chip_smoke.split_from_sessions`` on the CPU: how the smoke reads the
profiler's device records into a kernel's time launch by launch, with a
scripted list of sessions in place of ``torch.profiler``."""

import importlib.util
import pathlib

import pytest

KERNELS = {"delta": "attn_bwd_delta", "dq": "attn_bwd_dq"}
ITERS = 4
FILL = ("vectorized_elementwise_kernel<FillFunctor>", 0.002)


def load_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_split", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def full_session(delta_ms=0.01, dq_ms=0.05, n=ITERS):
    out = []
    for i in range(n):
        out += [FILL, ("attn_bwd_delta<64>", delta_ms * (1 + i)), ("attn_bwd_dq<64>", dq_ms)]
    return out


def run(smoke, sessions):
    script = iter(sessions)
    made = []

    def session():
        made.append(1)
        return next(script)

    return smoke.split_from_sessions(session, KERNELS, ITERS, len(sessions)), len(made)


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


def test_full_session_gives_medians_and_stops(smoke):
    got, made = run(smoke, [full_session(), [], []])
    assert made == 1
    assert got == {"delta": pytest.approx(0.025), "dq": pytest.approx(0.05)}


@pytest.mark.parametrize("lost", [1, 2])
def test_sessions_without_records_are_made_again(smoke, lost):
    got, made = run(smoke, [[]] * lost + [full_session(dq_ms=0.07)])
    assert made == lost + 1
    assert got["dq"] == pytest.approx(0.07)


def test_no_record_in_any_session_is_not_measured(smoke, capsys):
    got, made = run(smoke, [[], [], []])
    assert got is None and made == 3
    assert "not measured" in capsys.readouterr().out
    assert smoke.split_text(got) == "not measured"


@pytest.mark.parametrize("later", [[], [FILL] * ITERS])
def test_a_missing_kernel_fails_the_run(smoke, later):
    """The fills came back and dQ did not: a kernel is missing, whatever
    the later sessions return (nothing, or fills alone)."""
    no_dq = [ev for ev in full_session() if "dq" not in ev[0]]
    with pytest.raises(smoke.SmokeFailure, match="a kernel is missing"):
        run(smoke, [no_dq, later, later])


def test_short_sessions_keep_the_last_with_records(smoke, capsys):
    short = full_session(n=2)
    got, made = run(smoke, [full_session(n=1), short, []])
    assert made == 3
    assert got == {"delta": pytest.approx(0.015), "dq": pytest.approx(0.05)}
    assert "medians of those" in capsys.readouterr().out
    assert smoke.split_text(got) == "delta 15.0, dq 50.0 us"
