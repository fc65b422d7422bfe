"""A cell over several ranks through the launcher's own code, on the CPU
over gloo at (4, 64/D, 64) a rank: the program is correct and every rank
makes the same calls; the control and each planted fault read ``correct``
false, a fault in one image also at the cell's 256 images; a rank that
raises or hangs ends the run, and no rank is left.  The reference and the
counts against plain arithmetic."""
import json
import os
import time

import pytest
import torch

from portbench import harness, ranks, readers, spec, trace

SEED = 2 ** 31 + 17


def _cell(d, images=4, **traffic):
    cell = spec.resolve("fft2_4096.weak4")
    cell.chips = d
    cell.sizes = dict(cell.sizes, n0=64, n1=64, images=images, ranks=d)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


def _launch(cell, factories, deadline_s=180.0):
    got = {}
    t = time.monotonic()
    rc = ranks.launch(cell, [(SEED + i, f) for i, f in enumerate(factories)],
                      0.3, False, harness.clock(), device="cpu",
                      deadline_s=deadline_s,
                      on_result=lambda i, r, found: got.update({i: (r,
                                                                    found)}))
    return rc, got, time.monotonic() - t


def _rank():
    import torch.distributed as dist
    return dist.get_rank()


def _program(cell):
    return spec.load_module(cell.builder, "config").program(cell.sizes,
                                                            cell.traffic)


# Faults, each a factory of a call that a rank unpickles.  Every rank
# still makes the program's calls, so that no collective is left waiting.

def unchanged(cell):
    """Rank 1 returns its input: a step that leaves its state unchanged."""
    prog = _program(cell)

    def call(inputs, slot):
        out = prog(inputs, slot)
        if _rank() == 1:
            return inputs["xr"][slot].clone(), inputs["xi"][slot].clone()
        return out
    return call


def rolled(cell):
    """Rank 1's rows of the spectrum rolled by one."""
    prog = _program(cell)

    def call(inputs, slot):
        out = prog(inputs, slot)
        return tuple(o.roll(1, dims=-2) for o in out) if _rank() == 1 else out
    return call


def _exchange(cell, broken):
    """The program with ``broken(real, *args)`` in place of the tiled
    all-to-all that ``parallel/fft2d.py`` calls."""
    from cfftpack_tpu_torch.parallel import fft2d
    prog, real = _program(cell), fft2d.all_to_all_tiled

    def call(inputs, slot):
        fft2d.all_to_all_tiled = lambda *a, **k: broken(real, *a, **k)
        try:
            return prog(inputs, slot)
        finally:
            fft2d.all_to_all_tiled = real
    return call


def half_exchange(cell):
    """Rank 1's half of each exchange left out: the chunks it receives
    from the upper half of the ranks read zero."""
    def broken(real, t, group, split_axis, concat_axis, **kw):
        out = real(t, group, split_axis, concat_axis, **kw)
        if _rank() != 1:
            return out
        out = tuple(o.clone() for o in out)
        for o in out:
            n = o.shape[concat_axis]
            o.narrow(concat_axis, n // 2, n - n // 2).zero_()
        return out
    return _exchange(cell, broken)


def no_exchange(cell):
    """The exchange between ranks left out: each rank tiles its own chunk
    where the others' would land."""
    def broken(real, t, group, split_axis, concat_axis, **kw):
        import torch.distributed as dist
        d, r = dist.get_world_size(group), dist.get_rank(group)
        return tuple(torch.cat([p.chunk(d, dim=split_axis)[r]] * d,
                               dim=concat_axis) for p in t)
    return _exchange(cell, broken)


def half_batch(cell):
    """Half of the batch left out: the program on the first half of the
    images, the rest of the spectrum zeros."""
    prog = _program(cell)

    def call(inputs, slot):
        h = inputs["xr"][slot].shape[0] // 2
        cut = dict(inputs, xr=[x[:h] for x in inputs["xr"]],
                   xi=[x[:h] for x in inputs["xi"]])
        return tuple(torch.cat([o, torch.zeros_like(o)])
                     for o in prog(cut, slot))
    return call


def altered(cell):
    """An answer altered where it is produced: in each image of rank 0's
    spectrum one element moved by a hundredth of the largest value."""
    prog = _program(cell)

    def call(inputs, slot):
        yr, yi = prog(inputs, slot)
        if _rank() == 0:
            yr = yr.clone()
            yr[:, 3, 5] += 0.01 * yr.abs().amax(dim=(1, 2))
        return yr, yi
    return call


def one_image(cell):
    """One image wrong: rank 2's rows of image 137 moved by a hundredth
    of their largest value."""
    prog = _program(cell)

    def call(inputs, slot):
        yr, yi = prog(inputs, slot)
        if _rank() == 2:
            yr = yr.clone()
            yr[137] += 0.01 * yr[137].abs().max()
        return yr, yi
    return call


def raises(cell):
    """Rank 1 raises at its first call."""
    prog = _program(cell)

    def call(inputs, slot):
        _pid(cell)
        if _rank() == 1:
            raise ValueError("planted")
        return prog(inputs, slot)
    return call


def hangs(cell):
    """Rank 1 never returns from its first call."""
    prog = _program(cell)

    def call(inputs, slot):
        _pid(cell)
        if _rank() == 1:
            time.sleep(3600)
        return prog(inputs, slot)
    return call


def _pid(cell):
    with open(os.path.join(cell.traffic["pid_dir"], str(_rank())), "w") as f:
        f.write(str(os.getpid()))


FAULTS = [unchanged, rolled, half_exchange, no_exchange, half_batch, altered]


@pytest.fixture(scope="module")
def four():
    """One launch at D = 4: the program, the control, each fault."""
    rc, got, _ = _launch(_cell(4), [None, ranks.control] + FAULTS)
    assert rc == 0
    return got


@pytest.mark.parametrize("d", [2, 4])
def test_program_is_correct_and_ranks_agree(d, four):
    if d == 4:
        r, found = four[0]
    else:
        rc, got, _ = _launch(_cell(2), [None, ranks.control])
        assert rc == 0
        (r, found), (ctl, _) = got[0], got[1]
        assert not ctl["correct"], ctl["checks"]
    assert r["correct"], r["checks"]
    assert found == []
    assert r["device"]["count"] == d and r["info"]["ranks"] == d
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["info"]["calls_by_rank"] == [r["attempted"]] * d
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"fft2_images_per_s", "setup_s"}
    json.dumps(r)


def test_control_is_not_correct(four):
    r, _ = four[1]
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("i", range(len(FAULTS)),
                         ids=[f.__name__ for f in FAULTS])
def test_fault_is_not_correct(i, four):
    r, _ = four[2 + i]
    assert not r["correct"], r["checks"]


def test_one_image_at_the_cells_batch_is_not_correct():
    """Every image of a kept call is checked: a fault in one of the
    cell's 256 images fails, whichever images are checked whole."""
    cell = _cell(4, images=256)
    assert spec.resolve("fft2_4096.weak4").sizes["images"] == 256
    rc, got, _ = _launch(cell, [None, one_image])
    assert rc == 0
    assert got[0][0]["correct"], got[0][0]["checks"]
    r = got[1][0]
    assert not r["correct"], r["checks"]
    assert r["info"]["compared"]


@pytest.mark.parametrize("fault", [raises, hangs])
def test_failed_rank_ends_every_rank(fault, tmp_path):
    deadline = 40.0
    rc, got, took = _launch(_cell(2, pid_dir=str(tmp_path)), [fault],
                            deadline_s=deadline)
    assert rc != 0 and got == {}
    assert took < deadline + ranks.GRACE_S + 10
    pids = [int(p.read_text()) for p in tmp_path.iterdir()]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("shape", [(2, 64, 64), (2, 60, 80)])
def test_reference_against_torch_fft2(shape):
    ref = spec.load_module(spec.resolve("fft2_4096.weak4").reference,
                           "reference")
    g = torch.Generator().manual_seed(5)
    x = torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                      torch.randn(shape, generator=g, dtype=torch.float64))
    n0, n1 = shape[1:]
    want = torch.fft.fft2(x) / (n0 * n1)
    for b in range(shape[0]):
        got = ref.spectrum_rows(x[b], torch.arange(n0))
        assert torch.allclose(got, want[b], rtol=0, atol=1e-13)
        rows = torch.tensor([n0 // 4, n0 // 4 + 3, n0 // 2 - 1])  # a rank
        assert torch.allclose(ref.spectrum_rows(x[b], rows), got[rows],
                              rtol=0, atol=1e-15)


def test_counts_by_hand():
    cell = spec.resolve("fft2_4096.weak4")
    mod = spec.load_module(cell.counts, "counts")
    sizes = dict(cell.sizes, n0=8, n1=16, ranks=4, images=3)
    # a rank's 3 x 2 x 16 complex64 block read and its spectrum written
    assert mod.ideal_bytes(sizes, cell.traffic) == 2 * 3 * 2 * 16 * 8
    # two exchanges, each sending 3 of the block's 4 chunks
    assert mod.link_bytes(sizes, cell.traffic) == 2 * 3 * 2 * 16 * 8 * 3 // 4
    full = mod.ideal_bytes(cell.sizes, cell.traffic)
    assert full == 2 * 256 * 1024 * 4096 * 8


def test_exchange_readers(tmp_path):
    """NCCL's kernels are the exchange, apart from the glue; the share of
    the link peak is the link bytes over their time."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
           "ts": 1, "dur": 50}]
    kernels = [("void k1_reg_kernel<float, 4096>(float*)", 10),
               ("void at::native::elementwise_kernel<128>()", 4),
               ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
                20),
               ("void cf_reg_kernel(CFArgs, float const*)", 12)]
    for corr, (name, dur) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": 2 + corr, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name,
                   "ts": 10 + 20 * corr, "dur": dur,
                   "args": {"correlation": corr}})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    cell = spec.resolve("fft2_4096.weak4")
    win = harness.Window(0.0, 2.0, 4, [0.1] * 4, [1e-4] * 4,
                         [0.5, 1.0, 1.5, 2.0])
    run = harness.Run(cell, 5.0, win, trace.parse(path), 3350, 3.35e12,
                      frozenset({"k1_reg_kernel", "cf_reg_kernel"}),
                      900, 4.5e11)
    assert readers.nccl_us(run) == 20
    assert readers.glue_us(run) == 4
    assert readers.kernel_us(run, ("cf_kernel", "cf_reg_kernel")) == 12
    assert readers.exchange_pct(run) == pytest.approx(100 * 900 / 4.5e11
                                                      / 20e-6)
    assert readers.roofline_pct(run) == pytest.approx(100 * 1e-9 / 46e-6)
    assert readers.images_per_s(run) == 256 * 4 / 2.0
    run.link_bytes_per_s = None
    assert readers.exchange_pct(run) is None
