"""The tools copied into folve_tpu_torch/tools against the JAX package's
on the same inputs: the hand-crafted MP3 frames, the LAME, TwoLAME and
mpg123 oracles, the Opus fixture encoder, the FLAC corpus generator and
the MP3 Huffman table recovery.  Each test needing a system library
skips, as the JAX tests do, when it is missing.  The copies write
under build/folve_tpu_torch/ by default, never into native/ or
tests/data/."""

import hashlib
import json
import pathlib

import numpy as np
import pytest

from folve_tpu.tools import gen_mp3_tables as j_gen
from folve_tpu.tools import make_flac_corpus as j_flac
from folve_tpu.tools import mp3_frames as j_frames
from folve_tpu.tools import mp3_oracle as j_mp3
from folve_tpu.tools import opus_oracle as j_opus
from folve_tpu_torch.tools import gen_mp3_tables as t_gen
from folve_tpu_torch.tools import make_flac_corpus as t_flac
from folve_tpu_torch.tools import mp3_frames as t_frames
from folve_tpu_torch.tools import mp3_oracle as t_mp3
from folve_tpu_torch.tools import opus_oracle as t_opus

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "folve_tpu_torch"
VENDORED_TABLES = ROOT / "native" / "mp3_huffman.inc"
VENDORED_CORPUS = ROOT / "tests" / "data" / "flac_corpus"


def _need_mp3():
    if not (j_mp3.lame_available() and j_mp3.mpg123_available()):
        pytest.skip("lame/mpg123 oracles not present")


def _digest(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    for p in sorted(path.rglob("*")) if path.is_dir() else [path]:
        if p.is_file():
            h.update(str(p.relative_to(path.parent)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _material(seed: int, n: int, ch: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    base = 0.3 * np.sin(2 * np.pi * 440 * t)
    x = np.stack([base + 0.1 * rng.standard_normal(n),
                  0.7 * base - 0.1 * rng.standard_normal(n)][:ch], axis=1)
    return x.astype(np.float32)


def test_bitpacker_bytes_equal():
    packers = [j_frames.BitPacker(), t_frames.BitPacker()]
    for bp in packers:
        bp.put(0x7FF, 11)
        bp.put(5, 3)
        bp.put_bits("1011001")
        bp.put(0, 1)
    assert packers[0].bytes() == packers[1].bytes()
    assert packers[0].bytes(pad_to=16) == packers[1].bytes(pad_to=16)


@pytest.mark.parametrize("bits,kw", [
    ("", {}),
    ("1" * 37, dict(big_values=3, table_select0=7, global_gain=180)),
    ("0110" * 9, dict(block_type=2, count1table_select=1, bitrate_idx=9)),
    ("10", dict(main_bits_gr1="0111", region0_count=3, region1_count=2, rate_idx=1)),
])
def test_craft_frame_bytes_equal(bits, kw):
    assert t_frames.craft_frame(bits, **kw) == j_frames.craft_frame(bits, **kw)
    assert t_frames.probe_stream(bits, **kw) == j_frames.probe_stream(bits, **kw)
    assert t_frames.SILENT == j_frames.SILENT


@pytest.mark.parametrize("encoder,ch,kw", [
    ("lame", 1, dict(kbps=128)),
    ("lame", 2, dict(kbps=192, mode=1, vbr=4)),
    ("twolame", 2, dict(kbps=192, mode=0)),
])
def test_encode_decode_round_trip_equal(encoder, ch, kw):
    """The port's oracle bytes and decoded PCM equal the JAX package's."""
    _need_mp3()
    if encoder == "twolame" and not j_mp3.twolame_available():
        pytest.skip("no twolame fixture encoder")
    x = _material(3, 44100, ch)
    blob = getattr(t_mp3, f"{encoder}_encode")(x, 44100, **kw)
    assert blob == getattr(j_mp3, f"{encoder}_encode")(x, 44100, **kw)
    got = t_mp3.mpg123_decode(blob, channels=ch)
    np.testing.assert_array_equal(got, j_mp3.mpg123_decode(blob, channels=ch))
    assert got.shape[1] == ch and got.shape[0] > 44100 // 2


@pytest.mark.parametrize("mode,ch", [("celt", 2), ("silk", 1)])
def test_opus_fixture_bytes_equal(mode, ch):
    if not j_opus.opus_available():
        pytest.skip("no libopus oracle")
    x = _material(4, 48000, ch)
    assert t_opus.opus_encode_ogg(x, mode=mode) == j_opus.opus_encode_ogg(x, mode=mode)


def test_flac_corpus_manifest_equal(tmp_path):
    try:
        j_flac._load_sndfile()
    except RuntimeError as e:
        pytest.skip(str(e))
    before = _digest(VENDORED_CORPUS)
    t_flac.main(str(tmp_path / "port"))
    j_flac.main(str(tmp_path / "jax"))
    got = json.loads((tmp_path / "port" / "manifest.json").read_text())
    want = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert got == want
    for name in want:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # The source PCM is the one the vendored corpus was made from.
    vendored = json.loads((VENDORED_CORPUS / "manifest.json").read_text())
    assert {k: v["pcm_sha256"] for k, v in got.items()} == \
        {k: v["pcm_sha256"] for k, v in vendored.items()}
    assert _digest(VENDORED_CORPUS) == before


def test_tools_write_under_build_not_native_or_tests_data():
    assert pathlib.Path(t_flac.DEFAULT_TARGET) == BUILD / "flac_corpus"
    assert pathlib.Path(t_gen.OUT_DIR) == BUILD


def test_walk_table_7_equal():
    """Under test_mp3.py::test_recovered_tables_still_match_oracle's gate."""
    _need_mp3()
    rec = t_gen.Recovery()
    rec.verify_count1b()
    jrec = j_gen.Recovery()
    jrec.verify_count1b()
    assert rec.walk_table(7) == jrec.walk_table(7)


def test_gen_mp3_tables_main_equals_vendored_tables(tmp_path, monkeypatch):
    """The whole recovery, written where OUT_DIR says, equals the tables
    native/ holds byte for byte; native/ itself is not written."""
    _need_mp3()
    before = _digest(VENDORED_TABLES)
    monkeypatch.setattr(t_gen, "OUT_DIR", str(tmp_path / "out"))
    assert t_gen.main() == 0
    assert (tmp_path / "out" / "mp3_huffman.inc").read_bytes() == VENDORED_TABLES.read_bytes()
    assert _digest(VENDORED_TABLES) == before
