"""The port's host I/O layer against the JAX package's: the native AIO
handle on each backend present, the page-aligned buffer, the swap store,
pool and swapper, the pipelined file writer, the Fast checkpoint engine,
and ``utils/memspace``'s degradation contract on a CPU build.

Files cross between the packages: what one writes, the other reads back
bit for bit (the same raw layout), and both writers produce the same
bytes as a plain ``write``. The Fast engine's files are byte-equal to the
Sync engine's.
"""

import logging
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.io.fast_file_writer import FastFileWriter as JaxWriter
from deepspeed_tpu.ops.native.aio import AsyncIOHandle as JaxAIO
from deepspeed_tpu.runtime.swap_tensor.swapper import \
    TensorSwapStore as JaxStore
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.io.fast_file_writer import (FastFileWriter,
                                                     WriteStream)
from deepspeed_tpu_torch.ops.native import builder
from deepspeed_tpu_torch.ops.native.aio import AsyncIOHandle, PinnedBuffer
from deepspeed_tpu_torch.runtime import checkpoint_engine as ce
from deepspeed_tpu_torch.runtime.swap_tensor import (AsyncTensorSwapper,
                                                     SwapBufferPool,
                                                     TensorSwapStore)
from deepspeed_tpu_torch.utils import memspace


def _data(n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        dtype)


def test_native_library_builds_into_the_package_build_dir():
    # g++ is in the image: the build must succeed, into _build/
    assert builder.native_status() == "built"
    lib = builder.require_native_lib()
    assert os.path.dirname(lib._name).endswith("_build")
    assert os.path.basename(lib._name).startswith("libdstpu_native_")


@pytest.mark.parametrize("backend", ["auto", "threads", "python"])
def test_aio_roundtrip_on_each_backend(tmp_path, backend):
    h = AsyncIOHandle(block_size=1 << 14, queue_depth=16, num_threads=2,
                      backend=backend)
    assert h.backend in ({"python"} if backend == "python"
                         else {"threads", "uring"})
    if backend == "threads":
        assert h.backend == "threads"
    ts = [_data(4097, i) for i in range(4)] + [_data(3001, 9, torch.bfloat16)]
    paths = [str(tmp_path / f"u{i}.bin") for i in range(len(ts))]
    for t, p in zip(ts, paths):
        h.async_pwrite(t, p)
    assert h.wait() == 0
    outs = [torch.empty_like(t) for t in ts]
    for o, p in zip(outs, paths):
        h.async_pread(o, p)
    assert h.wait() == 0
    for t, o in zip(ts, outs):
        assert torch.equal(t, o)
    if backend != "python":
        assert h.bytes_written() == sum(t.nbytes for t in ts)
        assert h.bytes_read() == sum(t.nbytes for t in ts)
    # a ranged write and read at a byte offset
    part = _data(100, 5)
    h.pwrite(part, paths[0], offset=400)
    got = torch.empty(4097)
    h.pread(got, paths[0])
    assert torch.equal(got[100:200], part)
    assert torch.equal(got[:100], ts[0][:100])
    # a short read fails loudly
    with pytest.raises(IOError):
        h.pread(torch.empty(10_000), paths[0])
    h.close()


def test_aio_uring_strict_works_or_refuses_loudly(tmp_path):
    try:
        h = AsyncIOHandle(block_size=4096, backend="uring")
    except IOError as e:
        assert "unavailable" in str(e)
        return
    assert h.backend == "uring"
    a = torch.arange(9999, dtype=torch.float32)
    h.pwrite(a, str(tmp_path / "s.bin"))
    b = torch.zeros_like(a)
    h.pread(b, str(tmp_path / "s.bin"))
    assert torch.equal(a, b)
    h.close()


def test_aio_rejects_what_native_code_cannot_take(tmp_path):
    h = AsyncIOHandle(backend="threads")
    with pytest.raises(ValueError, match="contiguous CPU"):
        h.async_pwrite(torch.zeros(4, 4).t(), str(tmp_path / "x"))
    with pytest.raises(ValueError, match="backend"):
        AsyncIOHandle(backend="libaio")
    h.close()


def test_files_cross_between_the_packages(tmp_path):
    """The JAX handle writes numpy, the port reads torch, and back."""
    jh, ph = JaxAIO(block_size=1 << 14), AsyncIOHandle(block_size=1 << 14)
    a = _data(50_001, 1)
    jh.pwrite(a.numpy(), str(tmp_path / "j.bin"))
    got = torch.empty_like(a)
    ph.pread(got, str(tmp_path / "j.bin"))
    assert torch.equal(got, a)
    ph.pwrite(a * 2, str(tmp_path / "p.bin"))
    back = np.empty(50_001, np.float32)
    jh.pread(back, str(tmp_path / "p.bin"))
    assert np.array_equal(back, (a * 2).numpy())
    jh.close()
    ph.close()


def test_pinned_buffer_is_page_aligned_and_zeroed():
    buf = PinnedBuffer(1 << 20, dtype=torch.float32)
    assert buf.tensor.numel() == (1 << 20) // 4
    assert buf.tensor.data_ptr() % 4096 == 0
    assert not buf.tensor.any()
    buf.tensor.fill_(3.0)
    assert float(buf.tensor.sum()) == 3.0 * (1 << 18)
    half = PinnedBuffer(4096, dtype=torch.bfloat16)
    assert half.tensor.dtype == torch.bfloat16 and half.tensor.numel() == 2048
    buf.free()
    half.free()
    assert buf.tensor is None
    buf.free()  # idempotent


def test_swap_store_whole_and_ranged(tmp_path):
    store = TensorSwapStore(str(tmp_path / "swap"))
    a = _data(1000, 2)
    store.register("layers/attn.wq.master", a, sync=True)
    assert store.contains("layers/attn.wq.master")
    assert torch.equal(store.swap_in("layers/attn.wq.master"), a)
    out = torch.empty(100)
    store.swap_in("layers/attn.wq.master", out, offset=300)
    assert torch.equal(out, a[300:400])
    # a reserved tensor written range by range
    store.reserve("m", 1000, torch.float32)
    for s in range(0, 1000, 300):
        store.swap_out("m", a[s:s + 300].clone() * 3, offset=s)
    store.wait()
    assert torch.equal(store.swap_in("m"), a * 3)
    with pytest.raises(ValueError, match="do not fit"):
        store.swap_out("m", torch.zeros(10), offset=995)
    with pytest.raises(ValueError, match="do not fit"):
        store.swap_in("m", torch.zeros(10, dtype=torch.bfloat16))
    assert store.nbytes() == 8000
    names = sorted(os.listdir(tmp_path / "swap"))
    assert len(names) == 2
    store.purge()
    assert os.listdir(tmp_path / "swap") == []


def test_swap_store_files_are_jax_compatible(tmp_path):
    """A name swapped out by the JAX store reads back in the port's, and
    the file names agree."""
    jstore = JaxStore(str(tmp_path))
    pstore = TensorSwapStore(str(tmp_path))
    a = _data(777, 4)
    jstore.swap_out("['embed']['tokens'].x.master", a.numpy(), sync=True)
    pstore.reserve("['embed']['tokens'].x.master", 777, torch.float32)
    assert torch.equal(pstore.swap_in("['embed']['tokens'].x.master"), a)
    assert jstore._path("a/b.c") == pstore._path("a/b.c")


def test_swap_buffer_pool_and_async_swapper(tmp_path):
    pool = SwapBufferPool(count=2, elems=1024)
    i, buf = pool.get()
    j, buf2 = pool.get()
    assert pool.available() == 0 and buf.data_ptr() % 4096 == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.get()
    buf.copy_(torch.arange(1024.0))
    sw = AsyncTensorSwapper()
    sw.swap_out(buf, str(tmp_path / "a.swp"))
    sw.wait()
    buf2.zero_()
    sw.swap_in(buf2, str(tmp_path / "a.swp"))
    sw.wait()
    assert torch.equal(buf2, torch.arange(1024.0))
    pool.put(i)
    pool.put(j)
    assert pool.available() == 2
    with pytest.raises(IOError, match="submit failed"):
        sw.swap_in(buf2, str(tmp_path / "missing.swp"))
    sw.wait()
    pool.free()


@pytest.mark.parametrize("buffer_size", [4096, 1 << 16, 1 << 22])
def test_fast_file_writer_bytes_equal_a_plain_write(tmp_path, buffer_size):
    rng = np.random.default_rng(5)
    pieces = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (1, 4095, 4096, 70_000, 3, 250_000)]
    plain = b"".join(pieces)
    with FastFileWriter(str(tmp_path / "f.bin"), buffer_size) as w:
        for p in pieces:
            assert w.write(p) == len(p)
    assert w.stats.bytes_written == len(plain)
    assert w.stats.write_calls == len(pieces)
    with open(tmp_path / "f.bin", "rb") as f:
        assert f.read() == plain
    with JaxWriter(str(tmp_path / "j.bin"), buffer_size) as jw:
        for p in pieces:
            jw.write(p)
    with open(tmp_path / "j.bin", "rb") as f:
        assert f.read() == plain
    with pytest.raises(ValueError, match="after close"):
        w.write(b"x")


def test_fast_file_writer_streams_torch_save(tmp_path):
    t = _data(10_000, 7)
    with FastFileWriter(str(tmp_path / "t.pt"), 4096) as w:
        torch.save(t, WriteStream(w))
    got = torch.load(str(tmp_path / "t.pt"), weights_only=True, mmap=True)
    assert torch.equal(got, t)


def _tree():
    return {"params": {"embed": {"tokens": _data(6400, 1).reshape(100, 64)},
                       "layers": {"w": _data(3000, 2, torch.bfloat16)}},
            "opt_count": torch.tensor(3),
            "loss_scale": {"scale": torch.tensor(2.0 ** 16,
                                                 dtype=torch.float64)}}


def test_fast_engine_payload_equals_the_sync_engines(tmp_path):
    tree = _tree()
    ce.SyncCheckpointEngine().save(str(tmp_path / "s"), tree)
    fast = ce.FastCheckpointEngine(buffer_size=4096)
    fast.save(str(tmp_path / "f"), tree)
    files = []
    for root, _, names in os.walk(tmp_path / "s"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "s")
                  for n in names]
    assert len(files) == 4
    for rel in files:
        with open(tmp_path / "s" / rel, "rb") as a, \
                open(tmp_path / "f" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    assert not [n for _, _, ns in os.walk(tmp_path / "f") for n in ns
                if n.endswith(".tmp")]
    # and it loads like any payload
    target = {k: v for k, v in _tree().items()}
    target["params"]["embed"]["tokens"] = torch.zeros(100, 64)
    nbytes, restored = fast.load(str(tmp_path / "f"), target)
    assert torch.equal(target["params"]["embed"]["tokens"],
                       tree["params"]["embed"]["tokens"])
    assert len(restored) == 4


def test_checkpoint_engine_selection_follows_jax(caplog):
    pick = ce.make_checkpoint_engine
    assert type(pick(load_config({}).checkpoint)) is ce.SyncCheckpointEngine
    cfg = load_config({"checkpoint": {"parallel_write_pipeline": True}})
    assert type(pick(cfg.checkpoint)) is ce.FastCheckpointEngine
    both = load_config({"checkpoint": {"parallel_write_pipeline": True,
                                       "async_save": True}})
    with caplog.at_level(logging.WARNING, logger=ce.logger.name):
        eng = pick(both.checkpoint)
    assert type(eng) is ce.DecoupledCheckpointEngine
    assert "async_save (decoupled engine) wins" in caplog.text


def test_memspace_degrades_to_one_memory_on_a_cpu_build():
    t = torch.arange(6.0)
    assert memspace.KINDS == ("device", "pinned_host")
    host = memspace.put(t, "pinned_host")
    assert torch.equal(host, t)
    if memspace.memories_supported():  # a CUDA build: really pinned
        assert memspace.is_on_host(host) and host.is_pinned()
    else:  # host and device are one memory
        assert memspace.memory_kind_of(host) == "unpinned_host"
        assert not memspace.is_on_host(host)
    dev = memspace.put(t, "device", device="cpu")
    assert dev.data_ptr() == t.data_ptr()  # already there: no copy
    tree = memspace.put_tree({"a": t, "b": {"c": t * 2}}, "pinned_host")
    assert torch.equal(tree["b"]["c"], t * 2)
    assert memspace.memory_kind_of(3.0) is None
    with pytest.raises(ValueError, match="memory kind"):
        memspace.put(t, "unpinned_host")
