"""The kernel library's C ABI and the launch protocol every kernel wrapper
shares (``ops/cuda/_build.py``), on the CPU.

``SIGNATURES`` is held to the ``extern "C"`` definitions of ``csrc/*.cu``
entry point by entry point, and every such definition must be in it: a
ctypes type that does not match its C parameter corrupts memory without a
word.  ``kernel_wrapper``, ``launch``, ``bind`` and ``plan`` run on a stub
library of Python functions.  Imports neither jax nor the JAX package."""

import ctypes
import re
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from various_image_processings_tpu_torch.ops.cuda import _build  # noqa: E402
from various_image_processings_tpu_torch.utils.profiling import SPANS  # noqa: E402

# ---------------------------------------------------------------------------
# the C ABI
# ---------------------------------------------------------------------------

C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float, "long long": ctypes.c_longlong,
           "int*": ctypes.POINTER(ctypes.c_int), "const char*": ctypes.c_char_p}
RETURNS = r"int|long long|const char\*"
EXTERN_C = re.compile(r'^extern "C" \{$(.*?)^\}  // extern "C"$', re.M | re.S)
DEFINITION = re.compile(rf"^({RETURNS}) (vip_\w+)\(([^)]*)\) \{{", re.M)


def c_type(decl: str):
    """The ctypes type of a C type, or of a parameter declaration."""
    decl = " ".join(decl.split())
    if decl not in C_TYPES:  # a parameter: drop its name
        decl = re.sub(r"\s*\w+$", "", decl).replace(" *", "*")
    return C_TYPES[decl]


def c_argtypes(params: str) -> list:
    return [c_type(p) for p in params.split(",")] if params.strip() else []


def c_parameters(source: str, name: str) -> list:
    """The ctypes type of each parameter of the C function ``name`` in
    ``source``, its first declaration or definition."""
    match = re.search(rf"\b(?:{RETURNS}) {name}\(([^)]*)\)", source)
    assert match, name
    return c_argtypes(match.group(1))


def c_definitions() -> dict:
    """name -> (restype, argtypes) of every function defined inside an
    ``extern "C"`` block of ``csrc/*.cu``."""
    found = {}
    for src in _build.sources():
        for block in EXTERN_C.findall(src.read_text()):
            for ret, name, params in DEFINITION.findall(block):
                assert name not in found, f"{name} defined twice"
                found[name] = (c_type(ret), c_argtypes(params))
    return found


DEFINED = c_definitions()


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_binding_matches_the_c_entry_point(name):
    assert name in DEFINED, f"{name} is defined in no extern \"C\" block of csrc/"
    assert _build.SIGNATURES[name] == DEFINED[name]


def test_every_c_entry_point_is_in_the_table():
    assert len(DEFINED) == 37
    assert sorted(DEFINED) == sorted(_build.SIGNATURES)


# ---------------------------------------------------------------------------
# the launch protocol, on a stub library
# ---------------------------------------------------------------------------

class StubLibrary:
    """``vip_stub`` records its arguments and returns ``err``; the planner
    ``vip_stub_plan`` counts how often it is asked."""

    def __init__(self, err: int = 0):
        self.err = err
        self.calls = []
        self.asked = 0

    def vip_stub(self, *args):
        self.calls.append(args)
        return self.err

    def vip_stub_plan(self, a, b):
        self.asked += 1
        return 10 * a + b

    @staticmethod
    def vip_cuda_error_string(err):
        return b"invalid configuration argument"


STREAM = 0x5000
LIKE = SimpleNamespace(device=-1)  # torch.cuda.device(-1) selects nothing


@pytest.fixture
def stub(monkeypatch):
    """A stub library behind load_library, the current stream a constant."""
    lib = StubLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: STREAM)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=STREAM))
    SPANS.start(1 << 8)
    try:
        yield lib
    finally:
        SPANS.stop()
        SPANS.drain()


stub_launches = 0


@_build.kernel_wrapper("stub", "stub_launches")
def stub_wrapper(x: int, check: bool = True) -> int:
    if not check:
        raise ValueError("the wrapper's own check")
    _build.launch("vip_stub", "stub", LIKE, x, 7)
    return 2 * x


@pytest.mark.parametrize("err", [0, 9])
def test_spans_nest_and_close_also_on_a_raise(stub, err):
    stub.err = err
    if err:
        with pytest.raises(RuntimeError):
            stub_wrapper(3)
    else:
        assert stub_wrapper(3) == 6
    d = SPANS.drain()
    assert d.names == ["cuda_wrappers.stub", "enqueue.stub"]
    assert d.parents == [-1, 0]
    assert all(end > 0 for end in d.ends)
    assert d.starts[0] <= d.starts[1] <= d.ends[1] <= d.ends[0]
    assert SPANS.top == -1


def test_a_wrapper_check_that_raises_closes_its_span_and_enqueues_nothing(stub):
    with pytest.raises(ValueError, match="own check"):
        stub_wrapper(3, check=False)
    d = SPANS.drain()
    assert d.names == ["cuda_wrappers.stub"] and d.ends[0] > 0
    assert stub.calls == []


@pytest.mark.parametrize("err", [0, 9])
def test_the_counter_rises_only_when_the_launch_went_in(stub, err):
    stub.err = err
    before = stub_launches
    for x in range(3):
        if err:
            with pytest.raises(RuntimeError):
                stub_wrapper(x)
        else:
            stub_wrapper(x)
    assert stub_launches - before == (0 if err else 3)
    assert stub.calls == [(x, 7, STREAM) for x in range(3)]  # the stream goes last


def test_the_error_names_the_kernel(stub):
    stub.err = 9
    with pytest.raises(RuntimeError, match=r"^stub kernel launch failed: invalid configuration "
                                           r"argument \(cudaError_t 9\)$"):
        stub_wrapper(1)


def test_a_bound_launch_reads_the_stream_once_and_counts_each_launch(stub, monkeypatch):
    go = _build.kernel_wrapper("stub_bound", "stub_launches", globals())(
        _build.bind("vip_stub", "stub_bound", LIKE, 1, 2))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)  # a later stream is not taken
    before = stub_launches
    go()
    go()
    assert stub_launches - before == 2
    assert stub.calls == [(1, 2, STREAM)] * 2
    assert SPANS.drain().names == ["cuda_wrappers.stub_bound", "enqueue.stub_bound"] * 2
    stub.err = 9
    with pytest.raises(RuntimeError, match="^stub_bound kernel launch failed"):
        go()
    assert stub_launches - before == 2


def test_a_wrapper_that_counts_itself_is_not_counted(stub):
    calls = []

    @_build.kernel_wrapper("stub", None)
    def counts_itself():
        calls.append(1)

    before = stub_launches
    counts_itself()
    assert calls == [1] and stub_launches == before
    assert SPANS.drain().names == ["cuda_wrappers.stub"]


def test_plan_asks_the_library_once_for_each_set_of_arguments(stub):
    _build.plan.cache_clear()
    try:
        assert [_build.plan("vip_stub_plan", a, b) for a, b in [(1, 2), (1, 2), (3, 4)]] \
            == [12, 12, 34]
        assert stub.asked == 2
    finally:
        _build.plan.cache_clear()


def test_launch_counters_are_the_module_ints_the_benchmark_reads():
    """Every ``*launches`` int under ``ops.cuda`` is a wrapper module's own
    counter: the protocol adds none of its own, which the benchmark's sum
    of them would count again."""
    import importlib
    import pkgutil

    from various_image_processings_tpu_torch.ops import cuda

    counters = set()
    for info in pkgutil.iter_modules(cuda.__path__):
        module = importlib.import_module(f"{cuda.__name__}.{info.name}")
        counters |= {f"{info.name}.{k}" for k, v in vars(module).items()
                     if k.endswith("launches") and type(v) is int}
    assert counters == {
        "adaptive_bilateral.launches", "bilateral.launches", "gradient.launches",
        "connectivity.pass_launches", "bilateral_texture.blur_rtv_launches", "bilateral_texture.guide_launches",
        "slic.association_launches", "slic.snap_keys_launches", "slic.update_launches",
        "slic.delta_e_launches", "wexler_fill.ring_pick_launches",
        "wexler_fill.filters_launches", "wexler_fill.commit_launches",
        "wexler_fill.diffusion_launches", "wexler_search.launches"}
