"""SLIC's connectivity pass on the card (``models/slic.py::connectivity_device``,
``csrc/components.cu``) against the host's.

On the CPU: the plain twin (``_connectivity_plain``: the kernels' stages in
torch ops, the merge a Python loop over the clusters of adjacent small
components) equals the native fused pass (``utils/native.py::
slic_connectivity``) and the JAX package's NumPy path, and its header counts
equal those of the native components; and a NumPy twin of the merge
kernels' design (a window of a cluster's members in ascending id merged in
rounds, each member committing once nothing before it can change its
decision, candidates stored for the parent in an arena of bounded size,
with a walk of the region's members where the arena was full) equals the
sequential merge, also where a snake of single pixels outgrows the
kernels' arena.  On the card (marker ``cuda``): the kernels equal the twin
and the native pass, on the same maps, on SLIC labels of a 4K photo-like
frame, and on snakes whose arena overflows (the members' walk); a call of
``superpixel_slic`` reads the device once and raises the pass's counters;
the ΔE metrics and the batched route keep the host's pass."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact  # noqa: E402
from various_image_processings_tpu_torch.models import slic  # noqa: E402
from various_image_processings_tpu_torch.utils import native  # noqa: E402

# a superpixel size S for each min_area (S² // 20) the merge runs at
SP_SIZE = {0: 4, 5: 10, 33: 26, 204: 64}
LABEL_MAPS = [(0, (60, 50), 6), (1, (37, 83), 12), (2, (128, 128), 40), (3, (1, 9), 3)]


def label_map(seed, shape, nlabels):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, nlabels, size=shape).astype(np.int32)
    lab = rng.randint(0, 255, size=shape + (3,)).astype(np.uint8)
    return labels, lab


def block_label_map(seed, shape, nlabels):
    """Labels in 6×6 blocks with 3% of the pixels relabelled at random: the
    fragments a k-means leaves, fewer than in pure noise."""
    labels, lab = label_map(seed, shape, nlabels)
    blocks = np.kron(labels[::6, ::6], np.ones((6, 6), np.int32))[:shape[0], :shape[1]]
    noise = np.random.RandomState(seed + 100).rand(*shape) < 0.03
    return np.where(noise, labels, blocks).astype(np.int32), lab


def all_distinct(h, w, seed=4):
    """Every pixel its own label: one cluster of every pixel below S = 5."""
    lab = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    return np.arange(h * w, dtype=np.int32).reshape(h, w), lab


def equal_means(seed=5):
    """One colour everywhere: every candidate at distance 0, ties to the lowest id."""
    labels, _ = label_map(seed, (40, 45), 7)
    return labels, np.full((40, 45, 3), 77, np.uint8)


def chain():
    """A pixel (label 2) nearer in colour to the 2-pixel component beside it
    (label 1) than to the big one around both, which label 1 is nearer to:
    small → small → big."""
    labels = np.zeros((8, 9), np.int32)
    labels[3, 3:5] = 1
    labels[3, 5] = 2
    lab = np.zeros((8, 9, 3), np.uint8)
    lab[3, 3:5] = 40
    lab[3, 5] = 60
    return labels, lab


def snake(length):
    """A row of single pixels (each its own label) under a row of 2×3 blocks
    (min_area 5: the blocks are big), the pixels all one colour and the
    blocks another: each pixel merges into the next, so the region grows
    along the row and borders ever more distinct blocks.  The candidates its
    members store for their parents add up to ~length²/6 ints, more than an
    arena of any fixed size a pixel holds once the row is long enough (the
    kernels' 10 ints a pixel past ~180 pixels)."""
    labels = np.empty((3, length), np.int32)
    labels[:2] = np.arange(length)[None] // 3
    labels[2] = length + np.arange(length)
    lab = np.full((3, length, 3), 128, np.uint8)
    lab[:2, :, 0] = 200
    lab[2, :, 0] = 50
    return labels, lab


CASES = (
    [(f"{make.__name__}-{seed}-{h}x{w}-area{area}", make, (seed, (h, w), n), area)
     for make in (label_map, block_label_map) for seed, (h, w), n in LABEL_MAPS
     for area in (0, 5, 33)]
    + [("row-1x40", label_map, (6, (1, 40), 3), 5), ("column-40x1", label_map, (7, (40, 1), 3), 5),
       ("one-label", label_map, (8, (23, 31), 1), 5),
       ("all-distinct-24x20", all_distinct, (24, 20), 5),
       ("equal-means", equal_means, (), 5), ("chain", chain, (), 5),
       ("blocks-S64", block_label_map, (9, (96, 80), 30), 204),
       ("snake-3x255", snake, (255,), 5)])


def case_map(make, args):
    return make(*args)


def reference_counts(labels, out, min_area):
    """The header's first six counts from the native components: components,
    small ones, clusters of small ones joined by adjacency, the largest
    cluster's members, regions, and the small components' list room."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    comp, ncomp = native.ccl_4conn(labels)
    sizes = np.bincount(comp.reshape(-1), minlength=ncomp)
    small = sizes < min_area
    u = np.concatenate([comp[:, :-1].reshape(-1), comp[:-1, :].reshape(-1)])
    v = np.concatenate([comp[:, 1:].reshape(-1), comp[1:, :].reshape(-1)])
    keep = (u != v) & small[u] & small[v]
    graph = coo_matrix((np.ones(int(keep.sum())), (u[keep], v[keep])), shape=(ncomp, ncomp))
    _, cluster = connected_components(graph, directed=False)
    per = np.bincount(cluster[small]) if small.any() else np.zeros(0, np.int64)
    per = per[per > 0]
    return [ncomp, int(small.sum()), len(per), int(per.max()) if len(per) else 0,
            int(out.max()) + 1, int((2 * sizes[small] + 2).sum())]


def jax_enforce_connectivity(labels, lab, sp_size):
    """The JAX package's NumPy path (its native library reported absent)."""
    from various_image_processings_tpu.models import slic as jslic
    from various_image_processings_tpu.utils import native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib", lambda: None)
        return jslic.enforce_connectivity(labels, lab, sp_size)


@pytest.mark.parametrize("name,make,args,area", CASES, ids=[c[0] for c in CASES])
def test_plain_twin_equals_native_and_jax(name, make, args, area):
    labels, lab = case_map(make, args)
    want = native.slic_connectivity(labels, lab, area)
    np.testing.assert_array_equal(want, jax_enforce_connectivity(labels, lab, SP_SIZE[area]))
    calls = slic.connectivity_calls
    out, header = slic.connectivity_device(torch.from_numpy(labels), torch.from_numpy(lab),
                                           SP_SIZE[area], impl="torch")
    assert slic.connectivity_calls == calls + 1
    assert out.dtype == torch.int32 and header.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want)
    assert header[:6].tolist() == reference_counts(labels, want, area)


def test_connectivity_device_refuses_what_it_does_not_take():
    labels, lab = label_map(0, (6, 7), 3)
    labels, lab = torch.from_numpy(labels), torch.from_numpy(lab)
    with pytest.raises(ValueError):
        slic.connectivity_device(labels, lab, 10, impl="cuda")  # a CPU tensor
    with pytest.raises(ValueError):
        slic.connectivity_device(labels, lab[:5], 10, impl="torch")
    with pytest.raises(ValueError):
        slic.connectivity_device(labels, lab, 10, impl="numpy")


# ---------------------------------------------------------------------------
# the merge kernels' design, as a NumPy twin
# ---------------------------------------------------------------------------

OPEN = -2
CACHE = 8


class MergeTwin:
    """The merge of ``cc_merge_warps`` / ``cc_merge_blocks`` one cluster at a
    time: a window of ``window`` members in ascending id; in each round every
    member of the window resolves its candidates against the state at the
    round's start (pass A), the committing ones that merge into a later small
    component store their distinct candidates (as far as the last CACHE
    tell) in one chunk of the arena (pass B), then all commit, then the
    blocked ones stay in the window in order."""

    def __init__(self, sizes, means, lists, cluster, min_area, window, arena_ints):
        n = len(sizes)
        self.sizes, self.means, self.lists = sizes, means, lists
        self.small = sizes < min_area
        self.par = np.where(self.small, OPEN, -1).astype(np.int64)
        self.next = np.full(n, -1, np.int64)
        self.tail = np.arange(n)
        self.pend = np.full(n, -1, np.int64)
        self.flag = np.zeros(n, bool)
        self.arena = np.zeros(arena_ints, np.int64)
        self.top = 0
        self.overflows = 0
        self.window = window
        self.cluster = cluster

    def distance(self, c1, c2):
        m1, m2 = self.means[c1], self.means[c2]
        dl = float(m1[0] - m2[0]) * 2.55
        da = float(m1[1] - m2[1])
        db = float(m1[2] - m2[2])
        return dl * dl + da * da + db * db

    def resolve(self, me, lo, store):
        """(blocked, best, distinct candidates in order); ``self.blocker``
        the uncommitted component that blocked."""
        best, best_d, cache, out = -1, 0.0, [], []
        par = self.par

        def visit(v):
            nonlocal best, best_d
            r = v
            while r < me:
                pr = par[r]
                if pr == OPEN:
                    self.blocker = r
                    return False
                if pr < 0:
                    break
                if pr < lo and par[pr] >= 0:
                    par[r] = par[pr]
                r = pr
            if r == me:
                return True
            if r not in cache:
                cache.insert(0, r)
                del cache[CACHE:]
                out.append(r)
            if not store:
                d = self.distance(me, r)
                if best < 0 or d < best_d or (d == best_d and r < best):
                    best, best_d = r, d
            return True

        if self.flag[me]:
            m = me
            while m != -1:
                if not all(visit(v) for v in self.lists[m]):
                    return True, -1, out
                m = self.next[m]
            return False, best, out
        if not all(visit(v) for v in self.lists[me]):
            return True, -1, out
        ch = self.pend[me]
        while ch != -1:
            count = self.arena[ch + 1]
            if not all(visit(v) for v in self.arena[ch + 2:ch + 2 + count]):
                return True, -1, out
            ch = self.arena[ch]
        return False, best, out

    def merge(self, members):
        """A member blocked by a component still uncommitted is not resolved again."""
        win, fetched, rounds, blockers = [], 0, 0, {}
        while True:
            take = min(self.window - len(win), len(members) - fetched)
            win += members[fetched:fetched + take]
            fetched += take
            if not win:
                return rounds
            rounds += 1
            lo = win[0]
            decided = []
            for c in win:
                if c in blockers and self.par[blockers[c]] == OPEN:
                    decided.append((True, -1, []))
                    continue
                decided.append(self.resolve(c, lo, False))
                if decided[-1][0]:
                    blockers[c] = self.blocker
            chunks = {}
            for c, (blocked, best, cands) in zip(win, decided):
                if not blocked and best > c and self.small[best]:
                    need = len(cands) + 2
                    at = self.top
                    self.top += need
                    if at + need <= len(self.arena):
                        _, _, again = self.resolve(c, lo, True)
                        assert again == cands
                        self.arena[at + 1] = len(again)
                        self.arena[at + 2:at + 2 + len(again)] = again
                        chunks[c] = at
            for c, (blocked, best, _) in zip(win, decided):
                if blocked:
                    continue
                self.par[c] = best
                if best > c and self.small[best]:
                    old = self.next[best]
                    self.next[best] = c
                    self.next[self.tail[c]] = old
                    if old == -1:
                        self.tail[best] = self.tail[c]
                    if c in chunks:
                        self.arena[chunks[c]] = self.pend[best]
                        self.pend[best] = chunks[c]
                    else:
                        self.flag[best] = True
                        self.overflows += 1
            win = [c for c, d in zip(win, decided) if d[0]]

    def roots(self):
        out = np.arange(len(self.par))
        for c in range(len(out)):
            r = c
            while self.par[r] >= 0:
                r = self.par[r]
            out[c] = r
        return out


def merge_twin(labels, lab, min_area, window, arena_ints):
    """Labels through the merge twin, each small component's list in the
    order of a raster walk of its boundary edges (the kernels append them in
    an order of their own: the result may not depend on it)."""
    comp, ncomp = native.ccl_4conn(labels)
    sums = native.component_sums(comp, lab, ncomp)
    sizes = sums[:, 5]
    means = sums[:, 2:5] // sizes[:, None]
    small = sizes < min_area
    lists = [[] for _ in range(ncomp)]
    h, w = comp.shape
    for y in range(h):
        for x in range(w):
            c = int(comp[y, x])
            for yy, xx in ((y, x + 1), (y + 1, x)):
                if yy < h and xx < w and comp[yy, xx] != c:
                    d = int(comp[yy, xx])
                    if small[c]:
                        lists[c].append(d)
                    if small[d]:
                        lists[d].insert(0, c)
    cluster = np.arange(ncomp)

    def find(c):
        while cluster[c] != c:
            c = cluster[c]
        return c

    for c in np.flatnonzero(small):
        for d in lists[c]:
            if small[d]:
                a, b = find(c), find(d)
                cluster[max(a, b)] = min(a, b)
    by_cluster = {}
    for c in np.flatnonzero(small):
        by_cluster.setdefault(find(c), []).append(int(c))
    twin = MergeTwin(sizes, means, lists, cluster, min_area, window, arena_ints)
    for k in sorted(by_cluster):
        twin.merge(by_cluster[k])
    return slic._compact(twin.roots(), comp), twin


DESIGN_CASES = [("block-60x50", block_label_map, (0, (60, 50), 6), 5),
                ("noise-30x34", label_map, (1, (30, 34), 12), 33),
                ("all-distinct-16x18", all_distinct, (16, 18), 5),
                ("equal-means", equal_means, (), 5)]


@pytest.mark.parametrize("window,arena", [(1, 1 << 16), (3, 1 << 16), (32, 1 << 16),
                                          (1024, 1 << 16), (32, 0), (32, 40)])
@pytest.mark.parametrize("name,make,args,area", DESIGN_CASES, ids=[c[0] for c in DESIGN_CASES])
def test_merge_design_equals_sequential(name, make, args, area, window, arena):
    """Any window, and an arena from roomy to none at all (every region then
    walked member by member), gives the sequential merge's labels."""
    labels, lab = case_map(make, args)
    got, twin = merge_twin(labels, lab, area, window, arena)
    np.testing.assert_array_equal(got, native.slic_connectivity(labels, lab, area))
    if arena == 0:
        assert twin.overflows > 0 or not twin.small.any()


# the arena csrc/components.cu gives the merge: the dead arrays from parent to
# root_px, 40 bytes a pixel
ARENA_INTS_PER_PIXEL = 10


@pytest.mark.parametrize("window", [32, 1024])
@pytest.mark.parametrize("length", [255, 1023])
def test_merge_design_overflows_the_cards_arena_on_a_snake(length, window):
    """The snake's chunks outgrow the kernels' arena: children find it full,
    their parents walk their members' own lists, and the labels stay the
    sequential merge's."""
    labels, lab = snake(length)
    got, twin = merge_twin(labels, lab, 5, window, ARENA_INTS_PER_PIXEL * labels.size)
    np.testing.assert_array_equal(got, native.slic_connectivity(labels, lab, 5))
    assert twin.overflows > 0 and twin.top > len(twin.arena)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,args,area", CASES, ids=[c[0] for c in CASES])
def test_kernels_equal_twin_and_native(cuda, name, make, args, area):
    from various_image_processings_tpu_torch.ops.cuda import connectivity as kcc

    labels, lab = case_map(make, args)
    launches, calls = kcc.pass_launches, slic.device_connectivity_calls
    out, header = slic.connectivity_device(torch.from_numpy(labels).to(cuda),
                                           torch.from_numpy(lab).to(cuda), SP_SIZE[area])
    torch.cuda.synchronize()
    assert kcc.pass_launches == launches + len(kcc.KERNELS)
    assert slic.device_connectivity_calls == calls + 1
    want = native.slic_connectivity(labels, lab, area)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    twin, twin_header = slic.connectivity_device(torch.from_numpy(labels), torch.from_numpy(lab),
                                                 SP_SIZE[area], impl="torch")
    assert header[:6].tolist() == twin_header[:6].tolist()
    assert header[:6].tolist() == reference_counts(labels, want, area)


def photo_like_labels(cuda, h, w, s, seed):
    """SLIC k-means labels and Lab of a photo-like frame made on the card."""
    import json
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from port_bench.inputs import u8_photo_like

    traffic = json.loads((root / "port_bench" / "traffic" / "u8_photo_like_2160x3840.json")
                         .read_text())
    traffic.update(height=h, width=w, pool_frames=1)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    frame = u8_photo_like.make_pool(traffic, gen, cuda)[0]
    lab = bgr2lab_u8_exact(frame)
    labels = slic.slic_device(lab, h, w, s, 10, 20.0)[0]
    return labels.contiguous(), lab.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,s,seed", [(2160, 3840, 10, 1), (2160, 3840, 10, 2 ** 31 + 7),
                                        (512, 512, 26, 3)])
def test_kernels_on_slic_labels_of_a_photo_like_frame(cuda, h, w, s, seed):
    labels, lab = photo_like_labels(cuda, h, w, s, seed)
    out, header = slic.connectivity_device(labels, lab, s)
    want = native.slic_connectivity(labels.cpu().numpy(), lab.cpu().numpy(), s * s // 20)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    assert header[6].item() >= 1 and header[0].item() >= header[1].item() >= header[2].item()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,s", [(256, 256, 10), (512, 512, 26)])
def test_one_cluster_of_every_component_is_exact(cuda, h, w, s):
    """All labels distinct (256², S = 10: one cluster of 65,536), and SLIC
    on noise (one cluster of nearly every component): the merge's worst
    cases, timed."""
    if h == 256:
        labels, lab = all_distinct(h, w)
    else:
        from various_image_processings_tpu_torch.core.rng import random_image
        img = torch.from_numpy(random_image(h, w)).to(cuda)
        lab_d = bgr2lab_u8_exact(img)
        labels = slic.slic_device(lab_d, h, w, s, 10, 20.0)[0].cpu().numpy()
        lab = lab_d.cpu().numpy()
    dl, dlab = torch.from_numpy(labels).to(cuda), torch.from_numpy(lab).to(cuda)
    slic.connectivity_device(dl, dlab, s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, header = slic.connectivity_device(dl, dlab, s)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"{h}x{w} S={s}: {ms:.3f} ms, header {header.tolist()}")
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  native.slic_connectivity(labels, lab, s * s // 20))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [255, 1023])
def test_kernels_walk_the_members_where_the_arena_is_full(cuda, length):
    """A snake of 255 pixels (a cluster a warp merges) and of 1023: the
    arena overflows (header slot 7 counts the children that found it full)
    and the labels still equal the native pass's and the twin's."""
    labels, lab = snake(length)
    out, header = slic.connectivity_device(torch.from_numpy(labels).to(cuda),
                                           torch.from_numpy(lab).to(cuda), 10)
    want = native.slic_connectivity(labels, lab, 5)
    np.testing.assert_array_equal(out.cpu().numpy(), want)
    twin, twin_header = slic.connectivity_device(torch.from_numpy(labels), torch.from_numpy(lab),
                                                 10, impl="torch")
    assert header[:6].tolist() == twin_header[:6].tolist()
    assert header[3].item() == length and header[7].item() > 0


@pytest.mark.cuda
def test_a_card_call_reads_once_and_counts_its_pass(cuda):
    from various_image_processings_tpu_torch.ops.cuda import connectivity as kcc

    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (97, 131, 3),
                                                             dtype=np.uint8)).to(cuda)
    want = vt.superpixel_slic(img.cpu(), 10, 3)
    syncs, launches = slic.host_syncs, kcc.pass_launches
    calls, clusters = slic.device_connectivity_calls, slic.merge_clusters
    got = vt.superpixel_slic(img, 10, 3)
    assert slic.host_syncs == syncs + 1
    assert kcc.pass_launches == launches + len(kcc.KERNELS)
    assert slic.device_connectivity_calls == calls + 1 and slic.merge_clusters > clusters
    assert got.device == img.device
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_delta_e_metrics_keep_the_host_pass(cuda, metric):
    img = np.random.default_rng(4).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    calls, host_calls = slic.device_connectivity_calls, slic.connectivity_calls
    got = vt.superpixel_slic(torch.from_numpy(img).to(cuda), 8, 3, metric=metric)
    assert slic.device_connectivity_calls == calls and slic.connectivity_calls == host_calls + 1
    lab = bgr2lab_u8_exact(torch.from_numpy(img).to(cuda))
    raw = slic.slic_device(lab, 40, 48, 8, 3, 20.0, metric)[0].cpu().numpy()
    want = slic.enforce_connectivity(raw, lab.cpu().numpy(), 8, metric)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_batched_route_keeps_the_host_pass(cuda):
    from various_image_processings_tpu_torch.parallel import superpixel_slic_batched

    imgs = np.random.default_rng(6).integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    calls = slic.device_connectivity_calls
    got = superpixel_slic_batched(imgs, 8, 3)
    assert slic.device_connectivity_calls == calls
    for img, out in zip(imgs, got):
        assert torch.equal(out.cpu(), vt.superpixel_slic(torch.from_numpy(img), 8, 3))
