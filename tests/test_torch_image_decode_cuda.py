"""The image decoders on the card: every committed fixture against PIL's
digests, and kernels D1-D4 against their plain versions.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax, nor PIL, nor the JAX package, so it runs where
only the port is installed (the card's machine has no PIL):

    python -m pytest --noconftest -m gpu tests/test_torch_image_decode_cuda.py

Every kernel is integer arithmetic, so each must equal its plain version
bit for bit (`torch.equal`), and every decoded fixture must have the
SHA-256 that PIL's pixels have (tests/data/make_image_fixtures.py).
"""
import glob
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.image import decode, jpeg, png, resample
from mmlspark_tpu_torch.image.ops import read_image_dir
from mmlspark_tpu_torch.io.sources import read_images
from mmlspark_tpu_torch.ops import image_decode as kern

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "images")
IMAGES = os.path.join(DATA, "*.[jp][pn]g")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(DATA, "expected.json")) as f:
        return json.load(f)


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.gpu
def test_read_image_dir_equals_pil_digests(cuda_device, expected):
    kern.reset_launches()
    t = read_image_dir(DATA, device=cuda_device)
    names = [os.path.basename(p) for p in t["path"]]
    assert names == sorted(expected["files"])       # expected.json skipped
    for name, img in zip(names, t["image"]):
        want = expected["files"][name]
        assert img.dtype == np.uint8 and list(img.shape) == want["shape"]
        assert _sha(img) == want["rgb_sha256"], name
    # one launch of each decoder kernel for the whole folder
    assert kern.launches == {"jpeg_idct_islow": 1, "jpeg_upsample_ycc_rgb": 1,
                             "png_unfilter": 1, "resample_bicubic_u8": 0}


@pytest.mark.gpu
def test_read_images_resized_equals_pil_digests(cuda_device, expected):
    kern.reset_launches()
    t = read_images(IMAGES, size=tuple(expected["resize"]),
                    device=cuda_device)
    assert t["image"].dtype == np.float32
    assert t["image"].shape[1:] == tuple(expected["resize"]) + (3,)
    for path, img in zip(t["path"], t["image"]):
        assert _sha(img) == expected["files"][os.path.basename(path)][
            "resized_sha256"], path
    assert kern.launches["resample_bicubic_u8"] == 2


def _parsed():
    files = sorted(glob.glob(IMAGES))
    parsed = [decode.parse_file(p) for p in files]
    return ([p for p in parsed if isinstance(p, jpeg.JpegImage)],
            [p for p in parsed if isinstance(p, png.PngImage)])


def _counted(name, fn, *args):
    before = kern.launches[name]
    out = fn(*args)
    assert kern.launches[name] == before + 1
    return out


@pytest.mark.gpu
def test_jpeg_kernels_equal_plain(cuda_device):
    jpegs, _ = _parsed()
    a = decode.jpeg_inputs(jpegs, cuda_device)
    args = (a["coefs"], a["quant"], a["block_plane"], a["planes"],
            a["plane_bytes"])
    planes = _counted("jpeg_idct_islow", kern.jpeg_idct, *args)
    assert planes.is_cuda
    assert torch.equal(planes, kern._idct_plain(*args))
    rgb = _counted("jpeg_upsample_ycc_rgb", kern.jpeg_color, planes,
                   a["color"], a["rgb_bytes"])
    assert torch.equal(rgb, kern._color_plain(planes, a["color"],
                                              a["rgb_bytes"]))


@pytest.mark.gpu
def test_png_kernel_equals_plain(cuda_device):
    _, pngs = _parsed()
    a = decode.png_inputs(pngs, cuda_device)
    args = (a["data"], a["passes"], a["raw_bytes"])
    raw = _counted("png_unfilter", kern.png_unfilter, *args)
    assert torch.equal(raw, kern._unfilter_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(224, 224), (1, 1), (600, 40)])
def test_resample_kernel_equals_plain(cuda_device, size):
    jpegs, pngs = _parsed()
    images = (decode._jpegs(jpegs, cuda_device)
              + decode._pngs(pngs, cuda_device))
    plans = [resample.plan(*im.shape[:2], *size) for im in images]
    for axis in ("h", "v"):
        todo = [i for i, p in enumerate(plans) if axis in p]
        a = decode.resample_inputs([images[i] for i in todo],
                                   [plans[i] for i in todo], axis,
                                   cuda_device)
        args = (a["images"], a["info"], a["bounds"], a["coefs"],
                a["vertical"], a["total"])
        out = _counted("resample_bicubic_u8", kern.resample, *args)
        assert torch.equal(out, kern._resample_plain(*args))
        for i, (o, h, w) in zip(todo, a["outs"]):
            images[i] = out[o:o + h * w * 3].view(h, w, 3)


@pytest.mark.gpu
def test_folder_rules_on_the_card(cuda_device, tmp_path):
    with open(os.path.join(DATA, "j420_q75.jpg"), "rb") as f:
        good = f.read()
    (tmp_path / "a.jpg").write_bytes(good)
    (tmp_path / "b.txt").write_text("not an image")
    (tmp_path / "c.png").write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 20)
    t = read_image_dir(str(tmp_path), device=cuda_device)
    assert [os.path.basename(p) for p in t["path"]] == ["a.jpg"]
    with pytest.raises(OSError):
        read_images(str(tmp_path / "*"), device=cuda_device)
    (tmp_path / "d.gif").write_bytes(b"GIF89a" + b"\0" * 20)
    with pytest.raises(NotImplementedError, match="GIF"):
        read_image_dir(str(tmp_path), device=cuda_device)
