"""The port's one captured-call helper (spslam_tpu_torch/cuda_graphs.py):
it is the only module that captures a CUDA graph, it depends on no module
of the program above it, and its bookkeeping (one capture a key, replays,
counts, spans, a failed capture left eager, a None key never cached) holds
with stand-ins for the CUDA stream and graph API, since the CPU has
neither."""

import ast
import contextlib
import pathlib

import pytest
import torch

from spslam_tpu_torch import cuda_graphs, tracing

PKG = pathlib.Path(__file__).resolve().parents[1] / "spslam_tpu_torch"


def _tree(path: pathlib.Path) -> ast.AST:
    return ast.parse(path.read_text(), filename=str(path))


def test_only_the_helper_captures_a_graph():
    """No module of the port but cuda_graphs.py names `torch.cuda.graph`,
    `CUDAGraph` or `torch.cuda.graphs`: a new graphed call goes through
    `CapturedCalls`."""
    names = {"graph", "graphs", "CUDAGraph", "make_graphed_callables"}
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        hits = sorted({n.attr for n in ast.walk(_tree(path))
                       if isinstance(n, ast.Attribute) and n.attr in names
                       and ast.unparse(n.value) in ("torch.cuda", "cuda")})
        if hits:
            found[str(path.relative_to(PKG))] = hits
    assert found == {"cuda_graphs.py": ["CUDAGraph", "graph"]}


def test_helper_imports_only_torch_and_tracing():
    """Arrows point one way: cuda_graphs.py imports nothing from
    mapping/, solver/ or tracking/."""
    imported = set()
    for n in ast.walk(_tree(PKG / "cuda_graphs.py")):
        if isinstance(n, ast.Import):
            imported |= {a.name for a in n.names}
        elif isinstance(n, ast.ImportFrom):
            imported |= {f"{'.' * n.level}{n.module or ''}:{a.name}" for a in n.names}
    assert imported == {"__future__:annotations", "logging", "threading", "torch", ".:tracing"}


class _Stream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass


class _Graph:
    """Replays by running the call it captured again on the same tensors."""

    def replay(self):
        self.call()


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's streams and graphs as stand-ins; returns a dict whose
    "fail" makes the next capture raise."""
    state = {"fail": False}

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode=None):
        if state["fail"]:
            raise RuntimeError("capture refused")
        yield

    none = lambda *a, **k: contextlib.nullcontext()  # noqa: E731
    for name, value in (("Stream", _Stream), ("current_stream", _Stream), ("device", none),
                        ("stream", none), ("CUDAGraph", _Graph), ("graph", graph)):
        monkeypatch.setattr(torch.cuda, name, value)
    return state


def _add(tensors):
    """A `build`: the call adds the two static tensors into one output."""
    a, b = tensors
    out = torch.empty_like(a)
    return lambda: (torch.add(a, b, out=out),)


def _fetch(out):
    return out[0].clone()


X1 = (torch.ones(3), torch.full((3,), 2.0))
X2 = (torch.full((3,), 5.0), torch.ones(3))


def test_a_key_is_captured_once_and_replayed(fake_cuda):
    """The first call gives the eager answer and captures; later calls of
    the key load the new inputs into the static tensors and replay, each
    under one `<prefix>_replay` span; the counts say so."""
    g = cuda_graphs.CapturedCalls("t")
    tracing.reset()
    tracing.enable()
    try:
        first = g.run("k", "cpu", X1, _add, _fetch)
        static, call, _, graph, _ = g._entries["k"]
        graph.call = call
        got = [g.run("k", "cpu", x, _add, _fetch) for x in (X2, X1)]
        names = [s.name for s in tracing.records()]
    finally:
        tracing.disable()
        tracing.reset()
    assert torch.equal(first, X1[0] + X1[1]) and torch.equal(got[1], first)
    assert torch.equal(got[0], X2[0] + X2[1])
    assert torch.equal(static[0], X1[0])            # loaded by the last call
    assert (g.captures, g.replays, g.failures) == (1, 2, 0)
    assert names == ["t_capture", "t_replay", "t_replay"]


def test_a_failed_capture_stays_eager_and_a_none_key_is_never_cached(fake_cuda):
    """A capture that raises is counted and leaves its key eager on its
    static tensors; a None key runs eagerly and adds no entry."""
    fake_cuda["fail"] = True
    g = cuda_graphs.CapturedCalls("t")
    assert torch.equal(g.run("k", "cpu", X1, _add, _fetch), X1[0] + X1[1])
    assert torch.equal(g.run("k", "cpu", X2, _add, _fetch), X2[0] + X2[1])
    assert g._entries["k"][3] is None
    assert torch.equal(g.run(None, "cpu", X2, _add, _fetch), X2[0] + X2[1])
    assert list(g._entries) == ["k"]
    assert (g.captures, g.replays, g.failures) == (0, 0, 1)
