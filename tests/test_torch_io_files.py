"""Port parity: `io/sources.py` and `io/streaming.py`.

Both packages in one process, on the same files:
- `read_csv` against the reference's native path (`native/kernels.cpp::
  parse_csv_floats`, built with the host's C++ compiler): the same
  names, dtypes and float32 bits, on a CSV with dates, mixed columns,
  `inf`/`nan`/hex fields, blank fields and decimals that lie just off,
  or exactly on, half way between two float32s (where a float64 parse
  cast to float32 rounds twice: the file holds hundreds of such fields);
- `read_binary_files` equal; `read_images` of files that are no images
  raises an OSError in both (tests/test_torch_image_decode.py holds it
  on images);
- `FileStreamSource` in binary and csv mode, step for step: the same
  (epoch, table) at every poll, commits that alone move positions,
  replay of the pending epoch, a torn last line held back, a drifted
  header and a file whose reads keep failing quarantined after
  `_READ_RETRIES` polls;
- `FileStreamQuery` with a sink that fails once: the batch replays and
  every row reaches the sink exactly once, as in the reference.
"""
import os
import threading
import time
from decimal import Decimal, getcontext
from fractions import Fraction

import numpy as np
import pytest
import torch

from mmlspark_tpu import native as ref_native
from mmlspark_tpu.io import sources as ref_sources
from mmlspark_tpu.io import streaming as ref_streaming
from mmlspark_tpu_torch.io import sources, streaming
from mmlspark_tpu_torch.io import FileStreamQuery, FileStreamSource

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    if a.dtype == np.float32:
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        assert (a == b).all()


def _tables_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in a.columns:
        _bits_equal(a[c], b[c])


# ------------------------------------------------------------------ read_csv
def _decimal(fr: Fraction) -> str:
    """The exact decimal of a dyadic rational."""
    getcontext().prec = 300
    s = format(Decimal(fr.numerator) / Decimal(fr.denominator), "f")
    return s if "." in s else s + "."


def _halfway_fields(n, seed):
    """Decimals on, just above and just below float32 midpoints; a
    float64 parse rounds the two off-midpoint kinds onto the midpoint."""
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    nxt = np.nextafter(f, np.float32(np.inf))
    out = []
    for i, (a, b) in enumerate(zip(f, nxt)):
        mid = (Fraction(float(a)) + Fraction(float(b))) / 2
        kind = i % 3
        if kind == 1:
            mid += Fraction(1, 10 ** 70)
        elif kind == 2:
            mid -= Fraction(1, 10 ** 70)
        out.append(_decimal(mid))
    return out


def _csv(path, n=300, seed=0):
    rng = np.random.default_rng(seed)
    halfway = _halfway_fields(n, seed)
    specials = ["inf", "-inf", "nan", "-nan", "1e-46", "1e40", "0x1.8p3",
                "-0x.cp-2", "+.5", "5.", "3.4028236e38", "-0"]
    lines = ["half,plain,special,blanks,date,mixed,allnan,ints"]
    for i in range(n):
        lines.append(",".join([
            halfway[i], f"{rng.standard_normal():.9g}",
            specials[i % len(specials)],
            [" 3.25 \t", "", "  ", "7"][i % 4],
            f"2024-{i % 12 + 1:02d}-{i % 28 + 1:02d}",
            "x7" if i == 17 else str(i),
            "nan", str(int(rng.integers(-1000, 1000)))
            + ("\r" if i % 5 == 0 else "")]))
        if i == 40:
            lines.append("")           # an empty line is skipped
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
    return halfway


def test_native_path_available():
    """The reference's native parser is the path the port matches."""
    assert ref_native.available()


def test_read_csv_bits_equal_native(tmp_path):
    path = str(tmp_path / "mixed.csv")
    halfway = _csv(path)
    ref = ref_sources.read_csv(path)
    got = sources.read_csv(path)
    assert list(got.columns) == list(ref.columns)
    for c in ref.columns:
        _bits_equal(ref[c], got[c])
    # text: the date and mixed columns (prefix-numeric and letters), the
    # all-NaN column; numeric: the rest
    assert [c for c in got.columns if got[c].dtype == object] == [
        "date", "mixed", "allnan"]
    # the file holds fields a float64 parse would round twice
    twice = [np.float32(float(h)) for h in halfway]
    assert sum(a != b for a, b in zip(twice, got["half"])) > 50


@pytest.mark.parametrize("field, want, clean", [
    (b"1.5", 1.5, True), (b" 2 \r", 2.0, True), (b"", None, True),
    (b"  ", None, True), (b"2024-01-01", None, False), (b"abc", None, False),
    (b"1e", None, False), (b"0x", None, False), (b"1_000", None, False),
    (b"infinity", np.inf, True), (b"infinit", None, False),
    (b"nan(123)", "nan", True), (b"-nan(0x10)", "nan", True),
    (b"nan(017)", "nan", True), (b"nan(1_2)", "nan", True),
    (b"nan(0xffffffffff)", "nan", True), (b"-0x1p-149", -2.0 ** -149, True),
])
def test_field_grammar(field, want, clean):
    """strtof's grammar as parse_csv_floats bounds it to a field."""
    val, ok = sources._parse_field(field)
    assert ok == clean
    if want is None:
        assert np.isnan(val)
    elif want == "nan":
        assert np.isnan(val) and ok
    else:
        assert val == np.float32(want)
    row = ref_native.parse_csv_native(field + b",1\n", 2, return_clean=True)
    ref_val, ref_clean = row[0][0, 0], row[1][0]
    assert bool(ref_clean) == ok
    assert np.array_equal(np.float32(ref_val).view(np.uint32),
                          np.float32(val).view(np.uint32))


def test_read_binary_files_equal_and_images_raise(tmp_path):
    for i in range(5):
        sub = tmp_path / ("d" if i % 2 else "e")
        sub.mkdir(exist_ok=True)
        (sub / f"f{i}.bin").write_bytes(os.urandom(100 + i))
    pattern = str(tmp_path / "**" / "*.bin")
    a = ref_sources.read_binary_files(pattern)
    b = sources.read_binary_files(pattern, npartitions=2)
    assert len(b) == 5 and b.npartitions == 2
    assert list(a["path"]) == list(b["path"])
    assert list(a["bytes"]) == list(b["bytes"])
    # none of the files is an image: PIL's UnidentifiedImageError in the
    # reference, the port's own, both OSErrors
    with pytest.raises(OSError):
        ref_sources.read_images(pattern)
    with pytest.raises(OSError, match="cannot identify image file"):
        sources.read_images(pattern, device="cpu")


# ------------------------------------------------------------------ streams
def _pair(pattern, mode):
    return (ref_streaming.FileStreamSource(pattern, mode=mode),
            FileStreamSource(pattern, mode=mode))


def _poll(pair):
    (ea, ta), (eb, tb) = pair[0].get_batch(), pair[1].get_batch()
    assert ea == eb
    _tables_equal(ta, tb)
    return eb, tb


def _commit(pair, epoch):
    for s in pair:
        s.commit(epoch)


def test_binary_stream_step_for_step(tmp_path):
    pair = _pair(str(tmp_path / "*.bin"), "binary")
    assert _poll(pair) == (0, None)
    (tmp_path / "a.bin").write_bytes(b"aa")
    assert _poll(pair)[1] is None             # first sighting: not stable
    e, t = _poll(pair)
    assert (e, len(t)) == (0, 1)
    (tmp_path / "b.bin").write_bytes(b"b")
    e2, t2 = _poll(pair)                      # uncommitted: replayed
    assert e2 == 0 and list(t2["path"]) == list(t["path"])
    _commit(pair, 0)
    _poll(pair)                               # b.bin's first sighting
    with open(tmp_path / "b.bin", "ab") as f:
        f.write(b"bb")                        # still growing
    assert _poll(pair)[1] is None
    e, t = _poll(pair)
    assert e == 1 and list(t["bytes"]) == [b"bbb"]
    _commit(pair, 0)                          # a stale commit: no effect
    assert _poll(pair)[0] == 1
    _commit(pair, 1)
    assert _poll(pair) == (2, None)


def test_csv_stream_step_for_step(tmp_path):
    pair = _pair(str(tmp_path / "*.csv"), "csv")
    a = tmp_path / "a.csv"
    a.write_text("user,res,n\n1,2,3\n4,5")    # a torn last line
    e, t = _poll(pair)
    assert e == 0 and len(t) == 1
    with open(a, "a") as f:
        f.write(",6\n7,x,9\n")               # completes it, and a bad cell
    e, t = _poll(pair)
    assert len(t) == 1                        # the pending epoch replays
    _commit(pair, 0)
    e, t = _poll(pair)
    assert e == 1 and len(t) == 2 and np.isnan(t["res"][1])
    (tmp_path / "b.csv").write_text("user,res,n\n10,11,12\n")
    (tmp_path / "c.csv").write_text("other,header\n1,2\n")    # drift
    e, t = _poll(pair)
    assert len(t) == 2                        # still epoch 1's rows
    _commit(pair, 1)
    e, t = _poll(pair)
    assert e == 2 and list(t["user"]) == [10.0]
    assert sorted(pair[1].quarantined) == sorted(pair[0].quarantined) == [
        str(tmp_path / "c.csv")]
    _commit(pair, 2)
    assert _poll(pair) == (3, None)


def test_csv_stream_quarantines_unreadable_after_retries(tmp_path):
    pair = _pair(str(tmp_path / "*.csv"), "csv")
    (tmp_path / "ok.csv").write_text("x,y\n1,2\n")
    (tmp_path / "bad.csv").mkdir()           # open() raises OSError
    bad = str(tmp_path / "bad.csv")
    retries = FileStreamSource._READ_RETRIES
    assert retries == ref_streaming.FileStreamSource._READ_RETRIES
    e, t = _poll(pair)
    _commit(pair, e)
    polls = 1
    while bad not in pair[1].quarantined:
        assert _poll(pair) == (1, None)
        polls += 1
        assert pair[1]._read_failures == pair[0]._read_failures
        assert sorted(pair[1].quarantined) == sorted(pair[0].quarantined)
    assert polls == retries + 1      # the poll past the retries quarantines
    assert bad in pair[0].quarantined


def _writer(path, rows, chunk):
    """Append `rows` as CSV lines in pieces that cut lines in two."""
    text = "".join(f"{i},{i % 7},{i * 0.5}\n" for i in rows).encode()
    with open(path, "ab") as f:
        for lo in range(0, len(text), chunk):
            f.write(text[lo:lo + chunk])
            f.flush()
            time.sleep(0.002)


def _run_query(module, path, n, fail_once=True):
    got, errors = [], {"left": 1 if fail_once else 0}
    lock = threading.Lock()

    def sink(t):
        with lock:
            if errors["left"]:
                errors["left"] -= 1
                raise RuntimeError("sink down")
            got.extend(t["id"].tolist())
    src = module.FileStreamSource(path, mode="csv")
    q = module.FileStreamQuery(src, lambda t: t, sink,
                               poll_interval=0.005).start()
    _writer(path.replace("*", "s"), range(n), chunk=37)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        with lock:
            if len(got) >= n:
                break
        time.sleep(0.01)
    q.stop()
    return got, q


@pytest.mark.parametrize("module", ["reference", "port"])
def test_query_replays_failed_epoch_exactly_once(tmp_path, module):
    mod = ref_streaming if module == "reference" else streaming
    d = tmp_path / module
    d.mkdir()
    (d / "s.csv").write_text("id,k,v\n")
    got, q = _run_query(mod, str(d / "*.csv"), 400)
    assert sorted(got) == list(range(400)) and len(got) == 400
    assert q._recoveries >= 1 and "sink down" in str(q._errors[0])
    assert FileStreamQuery.MAX_REPLAYS is None
