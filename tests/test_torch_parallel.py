"""The port's parallel layer on logical CPU meshes (8 shards of ``cpu``), the
twin of tests/test_parallel.py: every batched, sharded and batch-spatial
function must equal the port's single-device op exactly (tolerance 0), and
match the JAX package's parallel function on the conftest's 8-device CPU
mesh (impl="xla") within the single op's own tolerance: BF/JBF/ABF ≤ 1 u8,
the gradient equal, the BTF within its envelope, SLIC labels and the Wexler
fill equal.  The same images as the JAX tests (MT19937(42))."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu import parallel as jpar  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch import parallel as tpar  # noqa: E402
from various_image_processings_tpu_torch.core.rng import MT19937, random_image  # noqa: E402
from various_image_processings_tpu_torch.parallel import batch as tbatch  # noqa: E402
from various_image_processings_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from various_image_processings_tpu_torch.parallel import spatial as tspatial  # noqa: E402

CPU = torch.device("cpu")


def cpu_mesh(batch=None, spatial=1):
    return tpar.make_mesh(batch=batch, spatial=spatial, devices=[CPU] * 8)


def batch_images(b, h, w):
    raw = MT19937(42).raw(b * h * w * 3)
    return (raw % np.uint32(255)).astype(np.uint8).reshape(b, h, w, 3)


def max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def assert_equal(got, expected):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


def assert_btf_envelope(got, expected):
    """The BTF's end-to-end contract (tests/test_torch_bilateral_texture.py)."""
    d = np.abs(np.asarray(got).astype(np.int64) - np.asarray(expected).astype(np.int64))
    assert np.percentile(d, 99.9) <= 2 and d.max() <= 3, (np.percentile(d, 99.9), d.max())


def test_mesh_shapes():
    mesh = cpu_mesh()
    assert mesh.devices.size == 8 and mesh.shape == {"batch": 8, "y": 1}
    mesh2 = cpu_mesh(batch=4, spatial=2)
    assert mesh2.shape["batch"] == 4 and mesh2.shape["y"] == 2
    assert all(d == CPU for d in mesh2.devices.flat)
    with pytest.raises(ValueError, match="devices"):
        cpu_mesh(batch=16, spatial=1)
    with pytest.raises(ValueError, match="not divisible"):
        cpu_mesh(spatial=3)


def test_make_mesh_without_gpu_raises(monkeypatch):
    # the default mesh is every CUDA device; it never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.single_device_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.bilateral_filter_sharded(random_image(16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh(devices=["cuda:0"])


def test_halo_exchange_rows():
    img = torch.arange(8 * 2, dtype=torch.int32).reshape(8, 2)
    blocks = list(img.split(2))
    ext = tpar.halo_exchange_rows(blocks, 2)
    padded = torch.cat([img[:1], img[:1], img, img[-1:], img[-1:]])
    for i, e in enumerate(ext):
        assert torch.equal(e, padded[2 * i : 2 * i + 6])
    assert all(e is b for e, b in zip(tpar.halo_exchange_rows(blocks, 0), blocks))
    (one,) = tpar.halo_exchange_rows([img], 3)  # one shard: replicate both edges
    assert torch.equal(one, torch.cat([img[:1]] * 3 + [img] + [img[-1:]] * 3))
    with pytest.raises(ValueError, match="smaller than halo"):
        tpar.halo_exchange_rows(blocks, 3)


def test_batched_bilateral_matches_per_image():
    imgs = batch_images(8, 40, 40)
    out = tpar.bilateral_filter_batched(imgs, 9, 10.0, 30.0, mesh=cpu_mesh(batch=8))
    assert out.shape == (8, 40, 40, 3) and out.dtype == torch.uint8
    for i in range(8):
        assert_equal(out[i], vt.bilateral_filter(imgs[i], 9, 10.0, 30.0, device="cpu"))
    jax_out = jpar.bilateral_filter_batched(imgs, 9, 10.0, 30.0,
                                            mesh=jpar.make_mesh(batch=8, spatial=1),
                                            impl="xla")
    assert max_diff(out, jax_out) <= 1


def test_batched_rejects_indivisible_batch():
    imgs = batch_images(6, 16, 16)
    with pytest.raises(ValueError, match="divisible"):
        tpar.bilateral_filter_batched(imgs, mesh=cpu_mesh(batch=4))


@pytest.mark.parametrize("spatial,ksize", [(2, 9), (4, 9), (8, 9), (2, 31)])
def test_spatially_sharded_bilateral_bit_exact(spatial, ksize):
    # k=31 on 2 shards: the card takes the chunked kernel's route there
    img = batch_images(1, 64, 48)[0]
    out = tpar.bilateral_filter_sharded(img, ksize, 10.0, 30.0,
                                        mesh=cpu_mesh(batch=1, spatial=spatial))
    assert_equal(out, vt.bilateral_filter(img, ksize, 10.0, 30.0, device="cpu"))
    if ksize == 9:
        jax_out = jpar.bilateral_filter_sharded(img, 9, 10.0, 30.0,
                                                mesh=jpar.make_mesh(batch=1, spatial=spatial),
                                                impl="xla")
        assert max_diff(out, jax_out) <= 1


def test_sharded_on_a_two_axis_mesh_uses_the_first_batch_row():
    img = batch_images(1, 64, 48)[0]
    out = tpar.bilateral_filter_sharded(img, 9, mesh=cpu_mesh(batch=2, spatial=4))
    assert_equal(out, vt.bilateral_filter(img, 9, device="cpu"))


@pytest.mark.parametrize("batch,spatial,b", [(4, 2, 4), (2, 4, 6)])
def test_mixed_mesh_batch_and_spatial(batch, spatial, b):
    imgs = batch_images(b, 32, 32)
    mesh = cpu_mesh(batch=batch, spatial=spatial)
    out = tpar.bilateral_filter_batch_spatial(imgs, 9, 10.0, 30.0, mesh=mesh)
    for i in range(b):
        assert_equal(out[i], vt.bilateral_filter(imgs[i], device="cpu"))
    jax_out = jpar.bilateral_filter_batch_spatial(
        imgs, 9, 10.0, 30.0, mesh=jpar.make_mesh(batch=batch, spatial=spatial), impl="xla")
    assert max_diff(out, jax_out) <= 1


def test_joint_bilateral_batched_and_sharded():
    imgs = batch_images(4, 40, 40)
    guides = batch_images(4, 40, 40)[::-1].copy()
    out = tpar.joint_bilateral_filter_batched(imgs, guides, 9, 10.0, 30.0,
                                              mesh=cpu_mesh(batch=4))
    for i in range(4):
        assert_equal(out[i], vt.joint_bilateral_filter(imgs[i], guides[i], 9, 10.0, 30.0,
                                                       device="cpu"))
    jax_out = jpar.joint_bilateral_filter_batched(imgs, guides, 9, 10.0, 30.0,
                                                  mesh=jpar.make_mesh(batch=4, spatial=1),
                                                  impl="xla")
    assert max_diff(out, jax_out) <= 1

    sh = tpar.joint_bilateral_filter_sharded(imgs[0], guides[0], 9, 10.0, 30.0,
                                             mesh=cpu_mesh(batch=1, spatial=4))
    assert_equal(sh, vt.joint_bilateral_filter(imgs[0], guides[0], 9, 10.0, 30.0,
                                               device="cpu"))
    jax_sh = jpar.joint_bilateral_filter_sharded(imgs[0], guides[0], 9, 10.0, 30.0,
                                                 mesh=jpar.make_mesh(batch=1, spatial=4),
                                                 impl="xla")
    assert max_diff(sh, jax_sh) <= 1


@pytest.mark.parametrize("batch,spatial,b", [(4, 2, 4), (2, 4, 6)])
def test_joint_bilateral_batch_spatial_bit_exact(batch, spatial, b):
    imgs = batch_images(b, 32, 32)
    guides = batch_images(b, 32, 32)[::-1].copy()
    mesh = cpu_mesh(batch=batch, spatial=spatial)
    out = tpar.joint_bilateral_filter_batch_spatial(imgs, guides, 9, 10.0, 30.0, mesh=mesh)
    for i in range(b):
        assert_equal(out[i], vt.joint_bilateral_filter(imgs[i], guides[i], 9, 10.0, 30.0,
                                                       device="cpu"))
    if batch == 4:
        jax_out = jpar.joint_bilateral_filter_batch_spatial(
            imgs, guides, 9, 10.0, 30.0, mesh=jpar.make_mesh(batch=batch, spatial=spatial),
            impl="xla")
        assert max_diff(out, jax_out) <= 1


def test_batch_spatial_checks():
    imgs = batch_images(4, 30, 16)
    with pytest.raises(ValueError, match="not divisible by mesh batch axis"):
        tpar.bilateral_filter_batch_spatial(imgs[:3], mesh=cpu_mesh(batch=2, spatial=4))
    with pytest.raises(ValueError, match="not divisible by spatial axis"):
        tpar.bilateral_filter_batch_spatial(imgs, mesh=cpu_mesh(batch=2, spatial=4))
    with pytest.raises(ValueError, match="smaller than halo"):
        tpar.bilateral_filter_batch_spatial(imgs[:, :24], 15, mesh=cpu_mesh(batch=2, spatial=4))
    with pytest.raises(ValueError, match="differ"):
        tpar.joint_bilateral_filter_batch_spatial(imgs, imgs[:, :24],
                                                  mesh=cpu_mesh(batch=2, spatial=4))


def test_slic_batched_matches_per_image():
    imgs = batch_images(4, 48, 48)
    out = tpar.superpixel_slic_batched(imgs, superpixel_size=16, num_iteration=3,
                                       mesh=cpu_mesh(batch=4))
    assert out.shape == (4, 48, 48) and out.dtype == torch.int32
    for i in range(4):
        assert_equal(out[i], vt.superpixel_slic(imgs[i], 16, 3, device="cpu"))
    jax_out = jpar.superpixel_slic_batched(imgs, superpixel_size=16, num_iteration=3,
                                           mesh=jpar.make_mesh(batch=4, spatial=1))
    assert_equal(out, jax_out)


def test_slic_batched_warns_once_past_two_cells(monkeypatch):
    # every sub-batch's k-means reports a drift of 3 cells an image: the
    # JAX function warns once for the batch (its 5x5 gather misses windows
    # there); the port's association widens with the drift, so nothing warns
    real = tbatch.mslic.slic_device_batched

    def drifting(*args):
        labels, centers, dists, drift = real(*args)
        return labels, centers, dists, torch.full_like(drift, 3.0)

    monkeypatch.setattr(tbatch.mslic, "slic_device_batched", drifting)
    imgs = batch_images(2, 24, 24)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tpar.superpixel_slic_batched(imgs, 8, 2, mesh=cpu_mesh(batch=2))
    drift = [w for w in caught if issubclass(w.category, RuntimeWarning)
             and "drift" in str(w.message)]
    assert len(drift) == 0
    with pytest.raises(ValueError, match="divisible"):
        tpar.superpixel_slic_batched(imgs, 8, 2, mesh=cpu_mesh(batch=4))
    with pytest.raises(ValueError, match=">= 2"):
        tpar.superpixel_slic_batched(imgs, 1, 2, mesh=cpu_mesh(batch=2))


def test_wexler_batched_matches_per_image():
    size = 48
    img = np.zeros((size, size, 3), np.uint8)
    img[:, :, :] = ((np.arange(size) // 4) % 2 * 180 + 40).astype(np.uint8)[None, :, None]
    imgs = np.stack([img, img[:, ::-1]])
    mask = np.zeros((size, size), np.uint8)
    mask[20:26, 20:26] = 255
    masks = np.stack([mask, mask])
    out = tpar.inpainting_wexler_batched(imgs, masks, device="cpu")
    for i in range(2):
        assert_equal(out[i], vt.inpainting_wexler(imgs[i], masks[i], device="cpu"))
    assert_equal(out, jpar.inpainting_wexler_batched(imgs, masks))
    with pytest.raises(ValueError, match="batch sizes differ"):
        tpar.inpainting_wexler_batched(imgs, masks[:1], device="cpu")


def test_joint_bilateral_parallel_shape_mismatch():
    imgs = batch_images(4, 40, 40)
    with pytest.raises(ValueError, match="differ"):
        tpar.joint_bilateral_filter_batched(imgs, imgs[:, :32], mesh=cpu_mesh(batch=4))
    with pytest.raises(ValueError, match="differ"):
        tpar.joint_bilateral_filter_sharded(imgs[0], imgs[0][:32],
                                            mesh=cpu_mesh(batch=1, spatial=4))


def test_sharded_abf_and_gradient_bit_exact():
    img = batch_images(1, 64, 48)[0]
    mesh = cpu_mesh(batch=1, spatial=4)
    jmesh = jpar.make_mesh(batch=1, spatial=4)
    out = tpar.adaptive_bilateral_filter_sharded(img, 9, mesh=mesh)
    assert_equal(out, vt.adaptive_bilateral_filter(img, 9, device="cpu"))
    assert max_diff(out, jpar.adaptive_bilateral_filter_sharded(img, 9, mesh=jmesh,
                                                                impl="xla")) <= 1
    g = tpar.gradient_sharded(img, mesh=mesh)
    assert g.shape == (64, 48) and g.dtype == torch.float32
    assert_equal(g, vt.gradient(img, device="cpu"))
    assert_equal(g, jpar.gradient_sharded(img, mesh=jmesh, impl="xla"))


@pytest.mark.parametrize("spatial,nitr", [(2, 1), (4, 3)])
def test_sharded_btf_bit_exact(spatial, nitr):
    # per-stage halo exchange keeps even the global boundary bands exact
    img = batch_images(1, 128, 48)[0]
    out = tpar.bilateral_texture_filter_sharded(img, ksize=5, nitr=nitr,
                                                mesh=cpu_mesh(batch=1, spatial=spatial))
    assert_equal(out, vt.bilateral_texture_filter(img, 5, nitr, device="cpu"))
    if spatial == 4:
        jax_out = jpar.bilateral_texture_filter_sharded(
            img, ksize=5, nitr=nitr, mesh=jpar.make_mesh(batch=1, spatial=spatial), impl="xla")
        assert_btf_envelope(out, jax_out)


@pytest.mark.parametrize("nitr", [0, 2])
def test_sharded_btf_on_eight_shards_of_four_rows(nitr):
    # k=3: shards exactly as tall as the widest halo (2); nitr=0: a copy
    img = batch_images(1, 32, 24)[0]
    out = tpar.bilateral_texture_filter_sharded(img, 3, nitr,
                                                mesh=cpu_mesh(batch=1, spatial=8))
    assert_equal(out, vt.bilateral_texture_filter(img, 3, nitr, device="cpu"))
    assert out.data_ptr() != img.ctypes.data


def test_sharded_checks():
    img = batch_images(1, 30, 16)[0]
    mesh = cpu_mesh(batch=1, spatial=4)
    with pytest.raises(ValueError, match="not divisible by spatial axis"):
        tpar.bilateral_filter_sharded(img, mesh=mesh)
    with pytest.raises(ValueError, match="smaller than halo"):
        tpar.bilateral_filter_sharded(img[:24], 15, mesh=mesh)
    with pytest.raises(ValueError, match="widest stage halo"):
        tpar.bilateral_texture_filter_sharded(img[:24], 9, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by spatial axis"):
        tpar.bilateral_texture_filter_sharded(img, 3, mesh=mesh)


def test_cuda_impl_on_a_cpu_mesh_raises():
    # no fallback: impl="cuda" needs CUDA tensors, as the single-device ops
    img = batch_images(1, 32, 24)[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpar.bilateral_filter_sharded(img, 5, mesh=cpu_mesh(batch=1, spatial=2), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpar.bilateral_texture_filter_sharded(img, 3, 1, mesh=cpu_mesh(batch=1, spatial=2),
                                              impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpar.bilateral_filter_batched(img[None], 5, mesh=cpu_mesh(batch=1), impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        tpar.gradient_batched(img[None], mesh=cpu_mesh(batch=1), impl="pallas")


def test_sharded_torch_impl_equals_auto_on_cpu():
    img = batch_images(1, 64, 48)[0]
    mesh = cpu_mesh(batch=1, spatial=2)
    assert_equal(tpar.bilateral_filter_sharded(img, 5, 10.0, 30.0, mesh=mesh, impl="torch"),
                 tpar.bilateral_filter_sharded(img, 5, 10.0, 30.0, mesh=mesh))


def test_batched_abf_and_gradient():
    imgs = batch_images(4, 24, 24)
    mesh = cpu_mesh(batch=4)
    jmesh = jpar.make_mesh(batch=4, spatial=1)
    out = tpar.adaptive_bilateral_filter_batched(imgs, 9, mesh=mesh)
    for i in range(4):
        assert_equal(out[i], vt.adaptive_bilateral_filter(imgs[i], 9, device="cpu"))
    assert max_diff(out, jpar.adaptive_bilateral_filter_batched(imgs, 9, mesh=jmesh,
                                                                impl="xla")) <= 1
    g = tpar.gradient_batched(imgs, mesh=mesh)
    for i in range(4):
        assert_equal(g[i], vt.gradient(imgs[i], device="cpu"))
    assert_equal(g, jpar.gradient_batched(imgs, mesh=jmesh, impl="xla"))


def test_batched_btf_matches_per_image():
    imgs = batch_images(2, 40, 32)
    out = tpar.bilateral_texture_filter_batched(imgs, 5, 2, mesh=cpu_mesh(batch=2))
    for i in range(2):
        assert_equal(out[i], vt.bilateral_texture_filter(imgs[i], 5, 2, device="cpu"))


def test_batched_apply_rank_changing_fn():
    mesh = cpu_mesh(batch=2)
    imgs = torch.from_numpy(np.stack([random_image(16, 16) for _ in range(4)]))
    out = tpar.batched_apply(lambda im: vt.gradient(im), imgs, mesh)
    assert out.shape == (4, 16, 16) and out.dtype == torch.float32
    assert_equal(out[0], vt.gradient(imgs[0]))


def test_batched_apply_fresh_lambda_per_call_warns_nothing():
    # eager torch traces nothing, so the JAX layer's churn warning has no twin
    mesh = cpu_mesh(batch=2)
    imgs = torch.from_numpy(np.stack([random_image(8, 8) for _ in range(2)]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = [tpar.batched_apply(lambda im: im + 1, imgs, mesh) for _ in range(4)]
    assert not caught
    assert all(torch.equal(o, imgs + 1) for o in outs)


def test_stencil_apply_sharded_generic():
    img = batch_images(1, 64, 48)[0]
    guide = img[::-1].copy()
    mesh = cpu_mesh(batch=1, spatial=4)
    g = tpar.stencil_apply_sharded(lambda b: vt.gradient(b), img, 1, mesh, out_ndim=2)
    assert_equal(g, vt.gradient(img, device="cpu"))
    j = tpar.stencil_apply_sharded(lambda b, gd: vt.joint_bilateral_filter(b, gd, 5), img, 2,
                                   mesh, extras=(guide,))
    assert_equal(j, vt.joint_bilateral_filter(img, guide, 5, device="cpu"))
    with pytest.raises(ValueError, match="out_ndim"):
        tpar.stencil_apply_sharded(lambda b: vt.gradient(b), img, 1, mesh)
    with pytest.raises(ValueError, match="rows"):
        tpar.stencil_apply_sharded(lambda b, gd: b, img, 1, mesh, extras=(guide[:32],))


def test_gather_keeps_tensors_on_their_device():
    # a tensor input on the mesh's device is sharded as views: nothing but
    # the halo cats and the gather is copied
    img = torch.from_numpy(batch_images(1, 32, 16)[0])
    blocks = tspatial.split_rows(img, [CPU] * 4)
    assert all(b.data_ptr() == img[8 * i].data_ptr() for i, b in enumerate(blocks))
    out = tpar.bilateral_filter_sharded(img, 3, mesh=cpu_mesh(batch=1, spatial=4))
    assert out.device == CPU and out.data_ptr() != img.data_ptr()
