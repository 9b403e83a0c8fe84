"""The readers of the PCG graph route's counts, `pcg_graph_share` and
`pcg_masked_share`, on synthetic span records: the shares of the
``pcg`` spans' counts summed over the traced jobs; None off the card,
where the spans carry no such count (a port without the graph route,
as `cg_iter_ms`'s record has it) and where no iteration ran."""

import pytest

from benchmark.harness import cell as cells
from benchmark.tests.conftest import ROOT


class Span:
    def __init__(self, name, counts):
        self.name, self.counts = name, counts
        self.start_ns, self.end_ns, self.parent = 0, 1, -1


class Run:
    """What the readers use of `harness.runner.Run`: the device and the
    cached traced jobs."""

    def __init__(self, jobs, on_card=True):
        self.jobs, self.on_card = jobs, on_card

    def cached(self, key, fn):
        assert key == "spans"
        return self.jobs


def _reader(name):
    return cells.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                             name)


GRAPH = [[Span("job", {}),
          Span("pcg", {"iterations": 9, "replays": 1, "graph_iterations": 8,
                       "masked": 0}),
          Span("pcg", {"iterations": 13, "replays": 2,
                       "graph_iterations": 12, "masked": 4})],
         [Span("job", {}),
          Span("pcg", {"iterations": 0, "replays": 0, "graph_iterations": 0,
                       "masked": 0}),
          Span("pcg", {"iterations": 2, "replays": 0, "graph_iterations": 0,
                       "masked": 0})]]


@pytest.mark.parametrize("name,want", [("pcg_graph_share", 100 * 20 / 24),
                                       ("pcg_masked_share", 100 * 4 / 24)])
def test_shares_of_the_pcg_counts(name, want):
    read = _reader(name).read
    assert read(Run(GRAPH)) == pytest.approx(want)
    assert read(Run(GRAPH, on_card=False)) is None
    parent = [[Span("job", {}), Span("pcg", {"iterations": 9})]]
    assert read(Run(parent)) is None
    assert read(Run(None)) is None
    assert read(Run([[Span("pcg", {"iterations": 0, "graph_iterations": 0,
                                   "masked": 0})]])) is None
