"""The port's feature extractors (``mtd_gan_tpu_torch/features``) against
the JAX package's on the CPU: VGG19 slices, VGG16 with max and L2 pooling,
the ResNet50 blocks and the FID InceptionV3, on the same weights (a param
tree drawn with numpy from a seed, given to JAX as it is and to the port
through ``utils/torch_import``); the converters against the JAX importers;
both registries on the same torchvision-named weight files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mtd_gan_tpu.features import inception as jax_inception
from mtd_gan_tpu.features import registry as jax_registry
from mtd_gan_tpu.features import resnet as jax_resnet
from mtd_gan_tpu.features import vgg as jax_vgg
from mtd_gan_tpu_torch.features import inception, registry, resnet, vgg
from mtd_gan_tpu_torch.utils import torch_import
from tests.test_torch_feature_helpers import clear_feature_caches, draw_tree

# the tests share the machine with other test workers: one intra-op
# thread each keeps PyTorch from oversubscribing the cores
torch.set_num_threads(1)

# max |port - jax| / max |jax| per feature map (Inception: the relative
# 2-norm of the pool3 features): fp32 on both sides, convolutions summed in
# other orders (oneDNN against XLA), up to ~3e-6 measured through VGG19's
# 13 convs; 1e-4 leaves room for other CPUs' conv algorithms
TOL = 1e-4


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def rel_max(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def vgg19_tree():
    return draw_tree(jax_vgg.init_vgg19_params, 19)


@pytest.fixture(scope="module")
def vgg16_tree():
    return draw_tree(jax_vgg.init_vgg16_params, 16)


@pytest.fixture(scope="module")
def resnet50_tree():
    return draw_tree(jax_resnet.init_resnet50_params, 50)


@pytest.fixture(scope="module")
def inception_tree():
    return draw_tree(jax_inception.init_inception_params, 2015)


@torch.no_grad()
def test_vgg19_slices_match_jax(vgg19_tree):
    """The five PL / TML slices (relu1_1 ... relu5_1) at 256x256."""
    x = np.random.default_rng(1).random((1, 256, 256, 3), dtype=np.float32)
    want = jax.jit(jax_vgg.vgg19_features)(vgg19_tree, x)
    trunk = loaded(vgg.vgg19_trunk(), torch_import.vgg19_state_dict_from_flax(vgg19_tree))
    got = trunk(nchw(x))
    assert [tuple(g.shape) for g in got] == [
        (1, 64, 256, 256), (1, 128, 128, 128), (1, 256, 64, 64), (1, 512, 32, 32),
        (1, 512, 16, 16)]
    for g, w in zip(got, want):
        assert rel_max(g, np.asarray(w).transpose(0, 3, 1, 2)) < TOL


@pytest.mark.parametrize("pool", ["max", "l2"])
@torch.no_grad()
def test_vgg16_matches_jax(vgg16_tree, pool):
    """VGG16 at the LPIPS / DISTS ends, with max pooling and with DISTS's
    Hann L2 pooling, at 64x64."""
    tree = vgg16_tree
    x = np.random.default_rng(2).random((2, 64, 64, 3), dtype=np.float32)
    want = jax_vgg.vgg16_features(tree, x, pool=pool)
    trunk = loaded(vgg.vgg16_trunk(), torch_import.vgg16_state_dict_from_flax(tree))
    got = trunk(nchw(x), vgg.VGG16_LPIPS_ENDS, pool=pool)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert rel_max(g, np.asarray(w).transpose(0, 3, 1, 2)) < TOL


@pytest.mark.parametrize("size", [64, 57])
@torch.no_grad()
def test_resnet50_matches_jax(resnet50_tree, size):
    """The four block feature maps, batch norm in eval; 57 is odd, so the
    stride-2 convs pad "SAME" on both sides there and at the end only at 64."""
    tree = resnet50_tree
    x = np.random.default_rng(3).random((1, size, size, 3), dtype=np.float32)
    want = jax.jit(jax_resnet.resnet50_block_features)(tree, x)
    model = loaded(resnet.ResNet50Trunk(), torch_import.resnet50_state_dict_from_flax(tree))
    got = resnet.resnet50_block_features(model, nchw(x))
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        assert rel_max(g, w) < TOL


@pytest.mark.parametrize("size", [512, 64])
@torch.no_grad()
def test_inception_matches_jax(inception_tree, size):
    """pool3 features and logits of gray batches. 512 -> 299 is a downsample,
    where ``jax.image.resize`` filters (antialias); 64 -> 299 an upsample.
    At 512 the same network behind a plain ``F.interpolate`` (no antialias)
    misses the tolerance by far: the test tells the two resizes apart."""
    x = np.random.default_rng(4).random((2, size, size, 1), dtype=np.float32)
    want = np.asarray(jax.jit(jax_inception.inception_pool3_features)(inception_tree, x))
    fc = inception_tree["fc"]
    want_logits = want @ fc["kernel"] + fc["bias"]  # jax_inception.inception_logits
    model = loaded(inception.FIDInceptionV3(),
                   torch_import.inception_state_dict_from_flax(inception_tree))
    got = inception.inception_pool3_features(model, torch.from_numpy(x))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert got.shape == (2, 2048) and rel < TOL, rel
    logits = inception.inception_logits(model, torch.from_numpy(x)).numpy()
    assert np.linalg.norm(logits - want_logits) / np.linalg.norm(want_logits) < TOL
    if size == 512:
        plain = F.interpolate(nchw(x).expand(2, 3, size, size), size=(299, 299),
                              mode="bilinear", align_corners=False)
        off = model(plain * 2.0 - 1.0).numpy()
        assert np.linalg.norm(off - want) / np.linalg.norm(want) > 100 * TOL


@pytest.mark.parametrize("name", ["vgg19", "vgg16", "resnet50", "inception", "pieapp"])
def test_converters_invert_the_jax_importers(name):
    """The JAX package's ``import_torch_*`` reads the port's state dict
    back to the tree it came from, bit for bit."""
    from mtd_gan_tpu.metrics import learned as jax_learned
    init, importer, convert = {
        "vgg19": (jax_vgg.init_vgg19_params, jax_vgg.import_torch_vgg19,
                  torch_import.vgg19_state_dict_from_flax),
        "vgg16": (jax_vgg.init_vgg16_params, jax_vgg.import_torch_vgg16,
                  torch_import.vgg16_state_dict_from_flax),
        "resnet50": (jax_resnet.init_resnet50_params, jax_resnet.import_torch_resnet50,
                     torch_import.resnet50_state_dict_from_flax),
        "inception": (jax_inception.init_inception_params,
                      jax_inception.import_torch_inception,
                      torch_import.inception_state_dict_from_flax),
        "pieapp": (jax_learned.init_pieapp_params, jax_learned.import_torch_pieapp,
                   torch_import.pieapp_state_dict_from_flax),
    }[name]
    tree = draw_tree(init, 7)
    back = importer({k: v.numpy() for k, v in convert(tree).items()})
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


@pytest.fixture
def weights_dir(tmp_path, monkeypatch, vgg19_tree, inception_tree):
    """A directory with torchvision-named ``vgg19-*.pth`` (with a classifier
    entry, as torchvision's has) and ``pt_inception-*.pth`` files, named by
    ``MTD_GAN_TPU_WEIGHTS``; no other search root holds a file. The JAX
    package's and the port's caches are cleared before and after."""
    sd = torch_import.vgg19_state_dict_from_flax(vgg19_tree)
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    torch.save(sd, tmp_path / "vgg19-0000test.pth")
    torch.save(torch_import.inception_state_dict_from_flax(inception_tree),
               tmp_path / "pt_inception-2015-12-05-test.pth")
    monkeypatch.setenv("MTD_GAN_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    clear_feature_caches()
    yield tmp_path
    clear_feature_caches()


@torch.no_grad()
def test_registries_read_the_same_files(weights_dir):
    x = np.random.default_rng(5).random((2, 64, 64, 1), dtype=np.float32)
    want = jax_registry.get_vgg_slices_fn()(jnp.asarray(x[:, :32, :32]))
    got = registry.get_vgg_slices_fn("cpu")(torch.from_numpy(x[:, :32, :32]))
    for g, w in zip(got, want):
        assert rel_max(g, np.asarray(w).transpose(0, 3, 1, 2)) < TOL
    want = jax_registry.get_perceptual_fn()(jnp.asarray(x[:, :32, :32]))
    got = registry.get_perceptual_fn("wgan_vgg", "cpu")(torch.from_numpy(x[:, :32, :32]))
    assert got.shape == (2, 512, 2, 2)  # relu5_4
    assert rel_max(got, np.asarray(want).transpose(0, 3, 1, 2)) < TOL
    want = np.asarray(jax_registry.get_inception_feature_fn()(x))
    got = registry.get_inception_feature_fn("cpu")(torch.from_numpy(x)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL
    for status in (jax_registry.feature_weights_status(), registry.feature_weights_status()):
        assert str(weights_dir / "vgg19-0000test.pth") in status["vgg19"]
        assert "pt_inception-2015-12-05-test.pth" in status["inception"]


def test_registry_fallback_is_seeded_and_a_bad_file_raises(tmp_path, monkeypatch):
    """Without a file: seeded weights, the same on every build, reported as
    the fallback. A file that is found but does not load (not a state dict;
    a missing entry) raises instead of falling back."""
    for var, sub in (("MTD_GAN_TPU_WEIGHTS", "w"), ("TORCH_HOME", "t"), ("HOME", "h")):
        monkeypatch.setenv(var, str(tmp_path / sub))
    (tmp_path / "w").mkdir()
    registry.clear_cache()
    a, b = registry.build_extractor("vgg19"), registry.build_extractor("vgg19")
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert "seeded random fallback" in registry.feature_weights_status()["vgg19"]
    assert registry.get_extractor("vgg19", "cpu") is registry.get_extractor("vgg19", "cpu")
    with torch.no_grad():
        feats = registry.get_resnet_feature_fn("cpu")(torch.rand(1, 64, 64, 1))
    assert [tuple(f.shape) for f in feats] == [(1, 256, 16, 16), (1, 512, 8, 8),
                                               (1, 1024, 4, 4), (1, 2048, 2, 2)]
    assert "seeded random fallback" in registry.feature_weights_status()["resnet50"]
    (tmp_path / "w" / "vgg19-bad.pth").write_bytes(b"not a checkpoint")
    with pytest.raises(RuntimeError, match="did not load"):
        registry.build_extractor("vgg19")
    sd = vgg.vgg19_trunk().state_dict()
    del sd["features.0.bias"]
    torch.save(sd, tmp_path / "w" / "vgg19-bad.pth")
    with pytest.raises(RuntimeError, match="did not load"):
        registry.build_extractor("vgg19")
    registry.clear_cache()
