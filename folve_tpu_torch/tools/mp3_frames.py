"""Hand-crafted minimal MPEG-1 Layer III frames (dev/test tooling).

Builds single-purpose mono frames whose granule 0 carries arbitrary
main_data bits — the probe vehicle for the black-box recovery of the
ISO 11172-3 Huffman tables (tools/gen_mp3_tables.py) and for targeted
decoder tests.  Layout per ISO 11172-3 §2.4.1.7 / §2.4.2.7.
"""

from __future__ import annotations


class BitPacker:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def put_bits(self, bitstring: str):
        for b in bitstring:
            self.bits.append(1 if b == "1" else 0)

    def bytes(self, pad_to: int = 0) -> bytes:
        bits = self.bits + [0] * ((8 - len(self.bits) % 8) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            v = 0
            for b in bits[i : i + 8]:
                v = (v << 1) | b
            out.append(v)
        if pad_to and len(out) < pad_to:
            out += b"\x00" * (pad_to - len(out))
        return bytes(out)


def craft_frame(
    main_bits_gr0: str,
    big_values: int = 1,
    table_select0: int = 1,
    count1table_select: int = 0,
    global_gain: int = 210,
    main_bits_gr1: str = "",
    region0_count: int = 15,
    region1_count: int = 0,
    block_type: int = 0,
    rate_idx: int = 0,
    bitrate_idx: int = 14,
) -> bytes:
    """One mono MPEG-1 Layer III frame (44.1 kHz, 320 kbps by default).

    granule 0: part2_3_length == len(main_bits_gr0) EXACTLY (so the
    decoder consumes precisely the probe bits), scalefac_compress=0
    (zero scalefactor bits), the given big_values/table selection.
    granule 1: carries main_bits_gr1 (default: empty = silence).
    """
    frame_len = {14: 1044, 9: 417}[bitrate_idx]  # 144*kbps/44100
    bp = BitPacker()
    # ---- header
    bp.put(0x7FF, 11)  # sync
    bp.put(3, 2)  # MPEG-1
    bp.put(1, 2)  # Layer III
    bp.put(1, 1)  # no CRC
    bp.put(bitrate_idx, 4)
    bp.put(rate_idx, 2)
    bp.put(0, 1)  # padding
    bp.put(0, 1)  # private
    bp.put(3, 2)  # mono
    bp.put(0, 2)  # mode_ext
    bp.put(0, 1)  # copyright
    bp.put(1, 1)  # original
    bp.put(0, 2)  # emphasis
    # ---- side info (mono: 17 bytes)
    bp.put(0, 9)  # main_data_begin
    bp.put(0, 5)  # private
    bp.put(0, 4)  # scfsi
    for bits in (main_bits_gr0, main_bits_gr1):
        bp.put(len(bits), 12)  # part2_3_length
        bp.put(big_values if bits else 0, 9)
        bp.put(global_gain, 8)
        bp.put(0, 4)  # scalefac_compress = 0 -> slen1=slen2=0
        if block_type == 0:
            bp.put(0, 1)  # window_switching_flag
            bp.put(table_select0, 5)
            bp.put(table_select0, 5)  # region1 table (unused w/ bv=1)
            bp.put(0, 5)  # region2 table
            bp.put(region0_count, 4)
            bp.put(region1_count, 3)
        else:
            bp.put(1, 1)  # window_switching_flag
            bp.put(block_type, 2)
            bp.put(0, 1)  # mixed_block_flag
            bp.put(table_select0, 5)
            bp.put(table_select0, 5)
            bp.put(0, 9)  # subblock_gain x3
        bp.put(0, 1)  # preflag
        bp.put(0, 1)  # scalefac_scale
        bp.put(count1table_select, 1)
    # ---- main data (scalefactor part is empty: scalefac_compress=0)
    bp.put_bits(main_bits_gr0)
    bp.put_bits(main_bits_gr1)
    return bp.bytes(pad_to=frame_len)


SILENT = craft_frame("")


def probe_stream(main_bits: str, **kw) -> bytes:
    """A probe frame framed by silent frames (decoder warmup/flush)."""
    return SILENT + craft_frame(main_bits, **kw) + SILENT + SILENT
