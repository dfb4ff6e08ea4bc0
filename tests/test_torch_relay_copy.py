"""K4's routes (``kernels/relay_copy.py``) on the card: the line loop the
relay takes in both directions, and the kernels it replaced (the TMA tile
copy, the word loop), kept for timing.

On the card (marker ``card``; ``python -m pytest -m card
tests/test_torch_relay_copy.py``, which needs no JAX): the fetch and the
write-back bit for bit on every host allocation kind of
``kernels.host_alloc``, at 16-, 4- and 1-byte alignment, for multi-row and
half-row plans and a row of several megabytes; the launch counts by route;
the allocator's blocks freed with their last view; the stash's rows written
on one stream and fetched by K4 on another behind their write-backs, over
many repetitions.  On the CPU the tests skip.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.kernels import host_alloc as ha  # noqa: E402
from repro_torch.kernels import relay_copy as rc  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (dtype, width): 16-byte aligned rows, rows that start inside a 128-byte
# line (head and tail peeled off), 4-byte and 1-byte aligned rows
_ROWS = [(torch.float32, 1024), (torch.float32, 1028), (torch.float32, 1001),
         (torch.uint8, 1001), (torch.bfloat16, 333)]


def _vals(dt, n, w):
    return torch.arange(n * w).remainder(251).to(dt).view(n, w)


@pytest.mark.card
@pytest.mark.parametrize("route", list(rc.ROUTES))
@pytest.mark.parametrize("kind", ha.KINDS)
def test_fetch_bitwise_on_card(cuda, kind, route):
    for dt, w in _ROWS:
        vals = _vals(dt, 4, w)
        src = ha.empty((4, w), dt, kind=kind)
        src.copy_(vals)
        assert src.is_pinned()
        for start, size in ((1, 1), (3, 1), (0, 4), (1, 2)):
            before = rc.copy_rows.launches_by_route[route]
            got = rc.copy_rows(src, start, size=size, device=cuda,
                               route=route)
            assert rc.copy_rows.launches_by_route[route] == before + 1
            assert torch.equal(got.cpu(), vals[start:start + size]), \
                (kind, route, dt, w, start, size)


@pytest.mark.card
@pytest.mark.parametrize("route", list(rc.ROUTES))
@pytest.mark.parametrize("kind", ha.KINDS)
def test_writeback_bitwise_on_card(cuda, kind, route):
    for dt, w in _ROWS:
        vals = _vals(dt, 3, w).to(cuda)
        dst = ha.empty((3, w), dt, kind=kind)
        dst.copy_(torch.zeros(3, w, dtype=dt))
        for row in (2, 0):
            before = rc.writeback_rows.launches_by_route[route]
            rc.writeback_rows(vals[row], dst, row, route=route)
            assert rc.writeback_rows.launches_by_route[route] == before + 1
        back = rc.copy_rows(dst, 0, size=3, device=cuda)   # read on the card
        want = vals.clone()
        want[1] = 0
        assert torch.equal(back, want), (kind, route, dt, w)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["pinned", "write_combined"])
def test_large_row_both_ways_on_card(cuda, kind):
    """Rows of 24 MB: many tiles for every block of the grid."""
    g = torch.Generator(cuda).manual_seed(3)
    w = 6 * 1024 * 1024 + 7
    want = torch.randn(2, w, generator=g, device=cuda)
    host = ha.empty((2, w), torch.float32, kind=kind)
    for r in range(2):
        rc.writeback_rows(want[r], host, r)
    for r in range(2):
        assert torch.equal(rc.copy_rows(host, r, size=1, device=cuda)[0],
                           want[r])
    assert torch.equal(rc.copy_rows(host, 0, size=2, device=cuda), want)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["mapped", "write_combined", "huge_pages"])
def test_host_alloc_frees_with_its_last_view_on_card(cuda, kind):
    before = ha.live()
    a = ha.empty((5, 4096), torch.float32, kind=kind)
    view = a[2:].view(torch.int32)
    assert a.is_pinned() and view.is_pinned()
    assert ha.live()["blocks"] == before["blocks"] + 1
    assert ha.live()["bytes"] == before["bytes"] + 5 * 4096 * 4
    del a
    assert ha.live()["blocks"] == before["blocks"] + 1   # the view holds it
    view.fill_(7)
    assert torch.equal(rc.copy_rows(view.view(torch.float32).reshape(3, -1),
                                    0, size=3, device=cuda).cpu(),
                       torch.full((3, 4096), 7, dtype=torch.int32)
                       .view(torch.float32))
    del view
    assert ha.live() == before


@pytest.mark.card
def test_stash_rows_fetched_behind_their_writebacks_on_card(cuda):
    """The stash's path: each repetition writes rows on the write-back
    stream (``relay.Sink``) and fetches them by K4 on the copy stream into
    a ring slot (``relay_scan``'s ``xs``, each fetch behind the write-backs
    issued before it), the compute stream waiting on the fetch; every
    fetched row must be the one just written."""
    from repro_torch.core import eps, relay
    g = torch.Generator(cuda).manual_seed(5)
    copier, writer = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    place = eps.single_device_placement(cuda, stream=True)
    n, shape = 4, (2, 64, 96)
    for rep in range(50):
        rows = [torch.randn(shape, generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(n)]
        sink = relay.Sink(place, n, stream=writer)
        for i, r in enumerate(rows):
            sink.write(i, {"x": r})
        seen = []

        def body(c, slots, x):
            seen.append(x["x"].clone())
            return c, None
        w = torch.zeros(n, 8, device=cuda)
        relay.relay_scan(body, None, [relay.Stream(place, place.host(w))],
                         xs=sink.tree, reverse=rep % 2 == 1, prefetch=1,
                         transport="pallas", device=cuda, copy_stream=copier,
                         writeback_stream=writer)
        torch.cuda.synchronize()
        order = range(n - 1, -1, -1) if rep % 2 else range(n)
        for got, i in zip(seen, order):
            assert torch.equal(got, rows[i]), (rep, i)
