"""The port's bridge to the checkpoint reader's C++ data plane
(``flux_fp8_api_tpu_torch/utils/native_io.py`` over ``csrc/stload.cpp``): the cases of
tests/test_native_io.py on it, its build directory, its fallback to the mmap, and a
file the JAX package wrote read through both packages' native and mmap paths with
equal arrays and bytes. Host I/O only: exact equality throughout."""

from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import flux_fp8_api_tpu.utils.safetensors_io as jsio
from flux_fp8_api_tpu_torch.utils import native_io
from flux_fp8_api_tpu_torch.utils import safetensors_io as tsio

torch.set_num_threads(1)


def test_library_builds():
    lib = native_io.get_lib()
    assert lib is not None, "g++ build of csrc/stload.cpp failed"
    path = native_io.library_path()
    repo = Path(native_io.__file__).resolve().parents[2]
    assert path.exists() and path.parent.parent == native_io.BUILD_ROOT == repo / "build" / "native"
    assert not path.is_relative_to(repo / "native")  # never the JAX bridge's directory
    assert lib.stload_abi_version() == native_io.ABI_VERSION


def test_parallel_read_matches_file(tmp_path):
    path = tmp_path / "blob.bin"
    data = np.random.RandomState(0).bytes(3 * 1024 * 1024)
    path.write_bytes(data)
    out = native_io.parallel_read(str(path), 0, len(data), n_threads=4)
    assert out is not None and out.dtype == torch.uint8
    assert out.numpy().tobytes() == data


def test_parallel_read_with_offset(tmp_path):
    path = tmp_path / "blob.bin"
    data = bytes(range(256)) * 4096
    path.write_bytes(data)
    out = native_io.parallel_read(str(path), 1000, 5000, n_threads=2)
    assert out.numpy().tobytes() == data[1000:6000]


def test_missing_file_raises():
    if native_io.get_lib() is None:
        pytest.skip("native lib unavailable")
    with pytest.raises(OSError):
        native_io.parallel_read("/nonexistent/x.bin", 0, 10)


def test_prefetch(tmp_path):
    path = tmp_path / "p.bin"
    path.write_bytes(b"x" * 1024)
    assert native_io.prefetch(str(path)) is True
    assert native_io.prefetch(str(tmp_path / "missing.bin")) is False


def test_safetensors_native_path_equals_mmap(tmp_path, monkeypatch):
    path = str(tmp_path / "t.safetensors")
    tensors = {"w": torch.from_numpy(np.random.RandomState(1).randn(512, 257).astype(np.float32))}
    tsio.save_safetensors(path, tensors)
    monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", 1)  # force the native branch
    before = dict(tsio.READS)
    f_native = tsio.SafetensorsFile(path, use_native=True)
    f_mmap = tsio.SafetensorsFile(path, use_native=False)
    assert torch.equal(f_native.get("w"), f_mmap.get("w"))
    assert torch.equal(f_native.get("w"), tensors["w"])
    assert tsio.READS["native"] - before["native"] == 2 and tsio.READS["mmap"] - before["mmap"] == 1


def test_without_a_library_the_mmap_reads(tmp_path, monkeypatch):
    """No toolchain: the bridge answers None / False and the reader takes the mmap,
    with the same bytes (JAX's contract for host I/O)."""
    path = str(tmp_path / "t.safetensors")
    w = torch.arange(4096, dtype=torch.int32).reshape(64, 64)
    tsio.save_safetensors(path, {"w": w})
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_tried", False)
    monkeypatch.setattr(native_io, "library_path", lambda: tmp_path / "nowhere" / "libstload.so")
    monkeypatch.setattr(native_io.shutil, "which", lambda name: None)
    assert native_io.get_lib() is None and native_io.parallel_read(path, 0, 8) is None
    assert native_io.prefetch(path) is False
    monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", 1)
    before = dict(tsio.READS)
    assert torch.equal(tsio.SafetensorsFile(path, use_native=True).get("w"), w)
    assert tsio.READS["mmap"] - before["mmap"] == 1 and tsio.READS["native"] == before["native"]


def test_a_jax_written_file_reads_the_same_in_both_packages(tmp_path, monkeypatch):
    """A file the JAX package wrote (f32, bf16, fp8, int8, a 0-d and an empty tensor),
    read by JAX's SafetensorsFile through its native and mmap paths and by the port's
    through both: equal arrays and equal bytes everywhere."""
    r = np.random.RandomState(2)
    arrays = {
        "f32": r.randn(300, 70).astype(np.float32),
        "bf16": r.randn(129, 33).astype(ml_dtypes.bfloat16),
        "e4m3": r.uniform(-4, 4, size=(64, 48)).astype(ml_dtypes.float8_e4m3fn),
        "i8": r.randint(-128, 127, size=(77, 5)).astype(np.int8),
        "scalar": np.array(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "jax.safetensors")
    jsio.save_safetensors(path, arrays, metadata={"format": "pt"})
    monkeypatch.setattr(jsio, "_NATIVE_READ_THRESHOLD", 1)
    monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", 1)
    readers = {
        "jax native": jsio.SafetensorsFile(path, use_native=True),
        "jax mmap": jsio.SafetensorsFile(path, use_native=False),
        "port native": tsio.SafetensorsFile(path, use_native=True),
        "port mmap": tsio.SafetensorsFile(path, use_native=False),
    }
    assert readers["port native"].metadata == readers["jax native"].metadata == {"format": "pt"}
    for name, want in arrays.items():
        raw = want.tobytes()
        shape = readers["jax mmap"].get(name).shape  # the file's shape (JAX writes a 0-d array as [1])
        for who, f in readers.items():
            got = f.get(name)
            if isinstance(got, torch.Tensor):
                assert got.dtype == tsio.DTYPES[jsio._DTYPE_NAMES[want.dtype]], (who, name)
                got_bytes = got.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                assert tuple(got.shape) == shape and got_bytes == raw, (who, name)
            else:
                assert got.dtype == want.dtype and got.shape == shape and got.tobytes() == raw, (who, name)


def test_get_index_reads_one_block(tmp_path, monkeypatch):
    path = str(tmp_path / "s.safetensors")
    w = torch.randn(5, 7, 3)
    tsio.save_safetensors(path, {"w": w})
    for threshold in (1, 1 << 40):  # the native reader and the mmap
        monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", threshold)
        f = tsio.SafetensorsFile(path, use_native=True)
        assert all(torch.equal(f.get("w", i), w[i]) for i in range(-5, 5))
        with pytest.raises(IndexError):
            f.get("w", 5)


def test_a_prequantized_load_reads_each_stored_byte_once(tmp_path, monkeypatch):
    """load_prequantized reads a stacked leaf block by block: through the native reader
    each block's bytes alone, so the file's bytes are read once (a whole stacked leaf
    read per block would read each of them depth times), into the tree the mmap gives."""
    from flux_fp8_api_tpu_torch.utils import checkpoint as tckpt

    from .test_torch_checkpoint import _calibrated_jax, assert_same_model, pcfg
    from .torch_parity import to_torch

    path = str(tmp_path / "port.safetensors")
    tckpt.save_prequantized(path, to_torch(_calibrated_jax("fp8")), extra_meta={"version": "flux-dev"})
    plain = tsio.SafetensorsFile(path, use_native=False)
    via_mmap = tckpt.load_prequantized(plain, pcfg(), device="cpu")
    stored = sum(plain.get(k).numel() * plain.get(k).element_size() for k in plain.keys())
    sizes = []
    real = native_io.parallel_read
    monkeypatch.setattr(native_io, "parallel_read", lambda p, off, n, **kw: sizes.append(n) or real(p, off, n, **kw))
    monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", 1)
    f = tsio.SafetensorsFile(path, use_native=True)
    model = tckpt.load_prequantized(f, pcfg(), device="cpu")
    assert_same_model(model, via_mmap)
    assert sum(sizes) == stored


def test_the_default_reader_is_the_mmap(tmp_path, monkeypatch):
    """The port reads through the map unless asked (JAX's default is its native reader):
    on the card's host the map was the faster reader of a file in the page cache."""
    path = str(tmp_path / "d.safetensors")
    w = torch.randn(64, 64)
    tsio.save_safetensors(path, {"w": w})
    monkeypatch.setattr(tsio, "_NATIVE_READ_THRESHOLD", 1)
    prefetched = []
    monkeypatch.setattr(native_io, "prefetch", lambda p: prefetched.append(p) or True)
    before = dict(tsio.READS)
    f = tsio.SafetensorsFile(path)
    assert not f.use_native and torch.equal(f.get("w"), w) and prefetched == []
    assert tsio.READS["mmap"] - before["mmap"] == 1 and tsio.READS["native"] == before["native"]
