"""Copied from spring_tpu/io/ids.py; only the imports differ.

Paired-end read-ID pattern detection.

Reference analog: find_id_pattern / check_id_pattern / modify_id
(src/util.cpp:190-267). When every pair of ids in a PE dataset follows one
of three patterns, the file-2 ids need not be stored at all — the
decompressor regenerates them from the file-1 ids (src/decompress.cpp:373-394).

Pattern codes (same semantics as the reference):
  0: no pattern
  1: ids identical except the last char, '1' in file 1 and '2' in file 2
  2: ids byte-identical
  3: 'PREFIX 1SUFFIX' vs 'PREFIX 2SUFFIX' — the char after the first space
     is 1/2, everything else identical (modern Illumina '1:N:0:...' style)
"""
from __future__ import annotations


def find_id_pattern(id1: bytes, id2: bytes) -> int:
    if len(id1) != len(id2):
        return 0
    if id1 == id2:
        return 2
    if id1[-1:] == b"1" and id2[-1:] == b"2" and id1[:-1] == id2[:-1]:
        return 1
    if _match_code3(id1, id2):
        return 3
    return 0


def _match_code3(id1: bytes, id2: bytes) -> bool:
    sp = id1.find(b" ")
    if sp < 0 or sp + 1 >= len(id1):
        return False
    return (id1[: sp + 1] == id2[: sp + 1]
            and id1[sp + 1 : sp + 2] == b"1"
            and id2[sp + 1 : sp + 2] == b"2"
            and id1[sp + 2 :] == id2[sp + 2 :])


def check_id_pattern(id1: bytes, id2: bytes, code: int) -> bool:
    if len(id1) != len(id2):
        return False
    if code == 1:
        return id1[-1:] == b"1" and id2[-1:] == b"2" and id1[:-1] == id2[:-1]
    if code == 2:
        return id1 == id2
    if code == 3:
        return _match_code3(id1, id2)
    raise ValueError(f"invalid paired id code {code}")


def modify_id(id1: bytes, code: int) -> bytes:
    """Derive the file-2 id from the file-1 id under the given pattern."""
    if code == 2:
        return id1
    if code == 1:
        return id1[:-1] + b"2"
    if code == 3:
        sp = id1.find(b" ")
        return id1[: sp + 1] + b"2" + id1[sp + 2 :]
    raise ValueError(f"invalid paired id code {code}")
