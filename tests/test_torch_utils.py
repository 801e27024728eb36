"""kiss_tpu_torch host layer: imports without JAX, the copied numpy
utilities (codec, serializer, fasta, native) against kiss_tpu's and the
cases of tests/test_utils.py, the explicit-device rule, and timing."""

import io
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kiss_tpu.utils import codec as jcodec
from kiss_tpu.utils import fasta as jfasta
from kiss_tpu.utils import serializer as jserializer
from kiss_tpu_torch.utils import codec, fasta, native, serializer, timing
from kiss_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_without_jax():
    """The port (package, CLI, every module of the slice) imports with
    JAX blocked and pulls in nothing of kiss_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import kiss_tpu_torch, kiss_tpu_torch.cli, kiss_tpu_torch.kernels\n"
        "import kiss_tpu_torch.models.fm_index, kiss_tpu_torch.ops.pack\n"
        "import kiss_tpu_torch.ops.suffix_sort, kiss_tpu_torch.ops.radix_sort\n"
        "import kiss_tpu_torch.utils.native, kiss_tpu_torch.utils.timing\n"
        "import kiss_tpu_torch.experiments.micro_kernels\n"
        "import kiss_tpu_torch.experiments.micro_copy\n"
        "import kiss_tpu_torch.utils.synth\n"
        "bad = [m for m in sys.modules if m == 'kiss_tpu' or "
        "m.startswith('kiss_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_codec_roundtrip():
    s = "ACGTacgtNNX"
    enc = codec.to_istring(s)
    np.testing.assert_array_equal(enc, [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 4])
    assert codec.to_string(enc[:8]) == "ACGTACGT"


def test_codec_hash_rhash():
    seq = codec.to_istring("GATTACA")
    key = codec.hash(seq)
    assert key == int("2033010", 4)
    np.testing.assert_array_equal(codec.rhash(key, 7), seq)


def test_rev_comp_and_fold():
    seq = codec.to_istring("ACGTN")
    np.testing.assert_array_equal(codec.rev_comp(seq),
                                  codec.to_istring("NACGT"))
    np.testing.assert_array_equal(codec.fold_to_acgt(seq), [0, 1, 2, 3, 0])


def test_codec_matches_kiss_tpu():
    rng = np.random.default_rng(0)
    raw = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
    np.testing.assert_array_equal(codec.to_istring(raw),
                                  jcodec.to_istring(raw))
    iseq = rng.integers(0, 5, 3000).astype(np.int8)
    assert codec.to_string(iseq) == jcodec.to_string(iseq)
    np.testing.assert_array_equal(codec.rev_comp(iseq), jcodec.rev_comp(iseq))
    np.testing.assert_array_equal(codec.fold_to_acgt(iseq),
                                  jcodec.fold_to_acgt(iseq))
    assert codec.hash(iseq[:20] % 4) == jcodec.hash(iseq[:20] % 4)


def test_fasta_text_and_fastq_modes(tmp_path):
    p = tmp_path / "x.fa"
    p.write_text(">chr1 description here\nACGT\nACG\n>chr2\nTTTT\n")
    seq = fasta.read_sequence(str(p))
    np.testing.assert_array_equal(seq, codec.to_istring("ACGTACGTTTT"))
    assert [r.name for r in fasta.parse_fasta(str(p))] == ["chr1", "chr2"]
    t = tmp_path / "x.txt"
    t.write_text("ACGT\nacgt\n")
    np.testing.assert_array_equal(
        fasta.read_sequence(str(t)), codec.to_istring("ACGTACGT")
    )
    q = tmp_path / "x.fq"
    q.write_text("@r1\nACGN\n+\nIIII\n@r2\nTT\n+\nII\n")
    np.testing.assert_array_equal(fasta.read_sequence(str(q)),
                                  jfasta.read_sequence(str(q)))


def test_fasta_roundtrip_matches_kiss_tpu(tmp_path):
    rng = np.random.default_rng(4)
    text = rng.integers(0, 4, 10_001).astype(np.int8)
    p = tmp_path / "r.fa"
    fasta.write_fasta(p, [fasta.FastaRecord("a", text[:7000]),
                          fasta.FastaRecord("b", text[7000:])])
    got = fasta.read_sequence(str(p))
    np.testing.assert_array_equal(got, text)
    np.testing.assert_array_equal(got, jfasta.read_sequence(str(p)))


def test_native_library_loads_committed_build():
    """The committed csrc/build/libkiss_io.so loads as it is (no build)
    and parses like kiss_tpu's reader."""
    assert native.available()
    data = b">x\nACGTN\nacg\n"
    np.testing.assert_array_equal(native.parse_sequence(data),
                                  codec.to_istring("ACGTNACG"))
    vals = np.array([1, 0, 2, 3, 3], dtype=np.int8)
    np.testing.assert_array_equal(native.pack_dibits(vals),
                                  serializer.pack_dibits(vals))


def test_dibit_and_bit_pack_layout():
    vals = np.array([1, 0, 2, 3, 3], dtype=np.int8)
    blocks = serializer.pack_dibits(vals)
    assert blocks[0] == 0b11100001
    assert blocks[1] == 0b00000011
    np.testing.assert_array_equal(serializer.unpack_dibits(blocks, 5), vals)
    bits = np.zeros(70, bool)
    bits[0] = bits[65] = True
    b64 = serializer.pack_bits_u64(bits)
    assert b64[0] == 1 and b64[1] == 2
    np.testing.assert_array_equal(serializer.unpack_bits_u64(b64, 70), bits)
    rng = np.random.default_rng(1)
    v = rng.integers(0, 4, 1001).astype(np.int8)
    np.testing.assert_array_equal(serializer.pack_dibits(v),
                                  jserializer.pack_dibits(v))


def test_save_load_range():
    buf = io.BytesIO()
    arr = np.arange(10, dtype=np.uint32)
    serializer.save_range(buf, len(arr), arr)
    serializer.save_range(buf, 0, b"")  # empty writes nothing
    buf.seek(0)
    count, raw = serializer.load_range(buf, serializer.scalar_bytes(4))
    assert count == 10
    np.testing.assert_array_equal(np.frombuffer(raw, np.uint32), arr)
    assert buf.read() == b""


def test_timing_stage_and_sync(caplog):
    timing.setup_logging(verbose=True)
    x = torch.arange(10)
    timing.sync((x, [x * 2]))  # CPU tensors: nothing to wait for
    with caplog.at_level(logging.DEBUG, logger="kiss_tpu_torch"):
        out = timing.staged("demo_stage", lambda: (x + 1, 3))
        with timing.stage("outer") as res:
            res["block_on"] = x
    msgs = [r.getMessage() for r in caplog.records]
    assert out[1] == 3
    assert any(m.startswith("demo_stage elapsed ") for m in msgs)
    assert any(m.startswith("outer elapsed ") for m in msgs)
    timing.setup_logging(verbose=False)
