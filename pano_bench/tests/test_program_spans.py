"""The program's own profiler ranges (``pano.<step>``, opened by the
port's ``timer.span``) land in the traced window beside the harness's
``pano_bench.`` spans. Every accepted reader and the breakdown read the
same with and without them."""

import pytest

from pano_bench.spec import Spec
from pano_bench.tests.test_arithmetic import canned, ev, make

SPEC = Spec()
READERS = [m["name"] for m in SPEC.bench["per_layer"]]


def with_program_spans():
    """canned() with the port's ranges nested inside and around the
    harness's spans, launches included, on the same thread."""
    a = "user_annotation"
    return canned() + [
        ev(a, "pano.detect", 5, 10),
        ev(a, "pano.ransac", 20, 30),
        ev(a, "pano.ransac.search", 20, 15),
        ev(a, "pano.ransac.finalize", 35, 15),
        ev(a, "pano.wait", 55, 4),
        ev(a, "pano.upload", 61, 3),
        ev(a, "pano.compose", 72, 8),
        ev(a, "pano.compose.context", 73, 6),
        ev(a, "pano.geometry", 71, 1),
        ev(a, "pano.mesh", 0, 95),
    ]


@pytest.mark.parametrize("name", READERS)
def test_readers_ignore_program_spans(name):
    read = SPEC.reader(name)
    assert read(make(with_program_spans())) == read(make())


def test_breakdown_ignores_program_spans():
    assert make(with_program_spans()).breakdown() == make().breakdown()
