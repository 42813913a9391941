"""The port's layout checker (``ggrs_tpu_torch/analysis/layout.py``): the
twin of tests/test_verify_layout.py, held against the JAX checker.

Every case of the JAX file runs here on the port's checker, and where a
case parses a snippet or a fixture tree the JAX checker is run on the same
input and must give the same answer (fixture trees are written under both
package prefixes and both host-source folders; the port's checker is
pointed at ``ggrs_tpu/`` with ``pkg="ggrs_tpu"`` and at the JAX tree's
``native/`` with ``host="native"``).  Then the port-only holds: the same findings over the
JAX tree, the digest kernel's mirrors, the ``u`` suffix, the named struct
format, mutations of a copy of the port's tree, and the runtime probes of
the port's host library.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

import ggrs_tpu.analysis as J
import ggrs_tpu.analysis.layout as JL
from ggrs_tpu_torch.analysis import (
    LAYOUT_HEADER_FIELDS,
    check_layout,
    parse_cpp_constants,
    parse_py_constants,
    parse_py_struct_formats,
    static_bank_header,
)
from ggrs_tpu_torch.analysis import layout as PL
from ggrs_tpu_torch.analysis.layout import (
    LAYOUT_FD_FIELDS,
    LAYOUT_FD_STRIDE,
    LAYOUT_RECV_FIELDS,
    LAYOUT_RECV_STRIDE,
    LAYOUT_REQ_FIELDS,
    LAYOUT_REQ_STRIDE,
    LAYOUT_ROUTE_FIELDS,
    LAYOUT_ROUTE_STRIDE,
    LAYOUT_SEND_FIELDS,
    LAYOUT_SEND_STRIDE,
    LAYOUT_STAGE_FIELDS,
    LAYOUT_STAGE_STRIDE,
    MIRRORED_CONSTANTS,
    _check_field_table,
    _check_header,
    _check_mirrors,
)
from ggrs_tpu_torch.net import _native

REPO = Path(__file__).resolve().parents[1]
PKG = "ggrs_tpu_torch"
# each package's C++ host sources: the port's own copies, the JAX tree's
HOST = f"{PKG}/csrc/host"
JAX_HOST = "native"


def same(fn_name, *args):
    """The port's ``fn_name`` on ``args``, held equal to the JAX one's."""
    got = getattr(PL, fn_name)(*args)
    assert got == getattr(JL, fn_name)(*args)
    return got


def write_both(root: Path, rel: str, text: str) -> None:
    """Write a fixture file under both packages' prefixes."""
    for pkg in (PKG, "ggrs_tpu"):
        path = root / pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def check_both(fn_name, root, *args):
    """The port's check on its own prefix; the same check pointed at the
    JAX prefix must give the JAX checker's findings."""
    port = getattr(PL, fn_name)
    assert port(root, *args, pkg="ggrs_tpu") == getattr(JL, fn_name)(root, *args)
    return port(root, *args)


# ----------------------------------------------------------------------
# parser goldens
# ----------------------------------------------------------------------


class TestCppParser:
    def test_constexpr_forms(self):
        src = """
        constexpr int kPlain = 42;
        constexpr int64_t kNeg = -70;
        constexpr size_t kShift = size_t{1} << 22;
        constexpr uint64_t kAllOnes = ~uint64_t{0};
        constexpr int64_t kNegShift = -(int64_t{1} << 62);
        constexpr uint8_t kHex = 0x80;
        static constexpr int kStatic = 7;
        """
        c = parse_cpp_constants(src)
        assert c == J.parse_cpp_constants(src)
        assert c["kPlain"] == 42
        assert c["kNeg"] == -70
        assert c["kShift"] == 1 << 22
        assert c["kAllOnes"] == (1 << 64) - 1
        assert c["kNegShift"] == -(1 << 62)
        assert c["kHex"] == 0x80
        assert c["kStatic"] == 7

    def test_enum_implicit_increment(self):
        src = """
        enum MsgTag : uint8_t {
          kTagA = 0,
          kTagB,      // implicit 1
          kTagC = 5,
          kTagD,      // implicit 6
        };
        enum class Verdict { kOk = 0, kErr = -3 };
        """
        c = parse_cpp_constants(src)
        assert c == J.parse_cpp_constants(src)
        assert (c["kTagA"], c["kTagB"], c["kTagC"], c["kTagD"]) == \
            (0, 1, 5, 6)
        assert c["kErr"] == -3

    def test_comments_do_not_confuse(self):
        src = """
        // constexpr int kCommented = 9;
        /* constexpr int kBlock = 10; */
        constexpr int kReal = 1;  // trailing = 2 garbage
        """
        c = parse_cpp_constants(src)
        assert c == J.parse_cpp_constants(src) == {"kReal": 1}

    def test_non_integer_skipped(self):
        src = (
            'constexpr char kName[] = "x";\n'
            "constexpr double kF = 1.5;\n"
            "constexpr int kOk = 3;\n"
        )
        assert parse_cpp_constants(src) == J.parse_cpp_constants(src) == {"kOk": 3}


class TestPySourceParser:
    def test_constants_and_folding(self):
        src = "A = 48\nB = 1 << 22\nC = -70\nD = A\n_E = 0x80\n"
        c = parse_py_constants(src)
        assert c == J.parse_py_constants(src)
        assert c == {"A": 48, "B": 1 << 22, "C": -70, "_E": 0x80}

    def test_struct_formats_direct_and_aliased(self):
        src = (
            "import struct\n"
            "from struct import unpack_from as uf\n"
            "pack = struct.pack\n"
            "H = struct.Struct('<2sBBII')\n"
            "def f(buf):\n"
            "    pack('<HI', 1, 2)\n"
            "    uf('<iqiqqBH', buf, 0)\n"
            "    struct.unpack('<qqq', buf)\n"
        )
        assert parse_py_struct_formats(src) == J.parse_py_struct_formats(src)
        fmts = {(s.func, s.fmt) for s in parse_py_struct_formats(src)}
        assert ("Struct", "<2sBBII") in fmts
        assert ("pack", "<HI") in fmts
        assert ("unpack_from", "<iqiqqBH") in fmts
        assert ("unpack", "<qqq") in fmts


# ----------------------------------------------------------------------
# deliberate-skew fixtures: the checker must FIRE on drift
# ----------------------------------------------------------------------


def _mini_tree(tmp_path, native_py_text: str) -> Path:
    """A minimal fake repo holding just the files _check_header reads, under
    both packages' prefixes and host-source folders."""
    for host in (HOST, JAX_HOST):
        (tmp_path / host).mkdir(parents=True)
        (tmp_path / host / "session_bank.cpp").write_text(
            "constexpr size_t kHdrStride = 48;\n"
        )
    write_both(tmp_path, "net/_native.py", native_py_text)
    return tmp_path


GOOD_FIELDS = (
    'BANK_HDR_FIELDS = (\n'
    '    ("flags", "<u4"), ("rec_len", "<u4"), ("err", "<i4"),\n'
    '    ("fa", "<i4"), ("landed", "<i8"), ("current", "<i8"),\n'
    '    ("confirmed", "<i8"), ("save_frame", "<i8"),\n'
    ')\n'
)


def _header(root):
    assert _check_header(root, "ggrs_tpu", JAX_HOST) == JL._check_header(root)
    return _check_header(root)


def _table(root, *args):
    assert _check_field_table(root, *args, pkg="ggrs_tpu") == \
        JL._check_field_table(root, *args)
    return _check_field_table(root, *args)


class TestDeliberateSkew:
    def test_clean_fixture_passes(self, tmp_path):
        root = _mini_tree(tmp_path, GOOD_FIELDS)
        assert _header(root) == []

    def test_one_byte_header_drift_fires(self, tmp_path):
        # err shrinks i4 -> i2: every later offset shifts, stride 46
        root = _mini_tree(
            tmp_path, GOOD_FIELDS.replace('("err", "<i4")',
                                          '("err", "<i2")')
        )
        findings = _header(root)
        assert findings, "1-byte field drift must fail lint"
        assert any("stride" in f.rule or "fields" in f.rule
                   for f in findings)

    def test_big_endian_field_fires(self, tmp_path):
        root = _mini_tree(
            tmp_path, GOOD_FIELDS.replace('("landed", "<i8")',
                                          '("landed", ">i8")')
        )
        assert any(
            f.rule == "layout/header-endian" for f in _header(root)
        )

    def test_native_stride_drift_fires(self, tmp_path):
        root = _mini_tree(tmp_path, GOOD_FIELDS)
        for host in (HOST, JAX_HOST):
            (root / host / "session_bank.cpp").write_text(
                "constexpr size_t kHdrStride = 56;\n"
            )
        assert any(
            f.rule == "layout/header-stride" for f in _header(root)
        )

    # ---- descriptor-plane structs (§21): same three layers of pinning --

    REQ_GOOD = (
        'BANK_REQ_FIELDS = (\n'
        '    ("pattern", "<u1"), ("rflags", "<u1"), ("n_adv", "<u2"),\n'
        '    ("adv_off", "<u4"), ("adv_stride", "<u4"),\n'
        '    ("ops_end", "<u4"), ("frame", "<i8"),\n'
        ')\n'
    )
    STAGE_GOOD = (
        'BANK_STAGE_FIELDS = (\n'
        '    ("slot", "<u4"), ("handle", "<i4"), ("frame", "<i8"),\n'
        '    ("off", "<u4"), ("len", "<u4"),\n'
        ')\n'
    )

    def _table_tree(self, tmp_path, text):
        write_both(tmp_path, "net/_native.py", text)
        return tmp_path

    def test_clean_req_table_passes(self, tmp_path):
        root = self._table_tree(tmp_path, self.REQ_GOOD + self.STAGE_GOOD)
        assert _table(
            root, "BANK_REQ_FIELDS", LAYOUT_REQ_FIELDS, LAYOUT_REQ_STRIDE
        ) == []
        assert _table(
            root, "BANK_STAGE_FIELDS", LAYOUT_STAGE_FIELDS,
            LAYOUT_STAGE_STRIDE,
        ) == []

    def test_req_one_byte_drift_fires(self, tmp_path):
        # n_adv shrinks u2 -> u1: every later offset shifts, stride 23
        root = self._table_tree(
            tmp_path,
            self.REQ_GOOD.replace('("n_adv", "<u2")', '("n_adv", "<u1")'),
        )
        findings = _table(
            root, "BANK_REQ_FIELDS", LAYOUT_REQ_FIELDS, LAYOUT_REQ_STRIDE
        )
        assert findings, "1-byte descriptor field drift must fail lint"
        assert any("stride" in f.rule or "fields" in f.rule
                   for f in findings)

    def test_stage_big_endian_fires(self, tmp_path):
        root = self._table_tree(
            tmp_path,
            self.STAGE_GOOD.replace('("frame", "<i8")',
                                    '("frame", ">i8")'),
        )
        assert any(
            f.rule == "layout/table-endian"
            for f in _table(
                root, "BANK_STAGE_FIELDS", LAYOUT_STAGE_FIELDS,
                LAYOUT_STAGE_STRIDE,
            )
        )

    RECV_GOOD = (
        'NET_RECV_FIELDS = (\n'
        '    ("slot", "<i4"), ("fd_idx", "<i4"), ("ip", "<u4"),\n'
        '    ("port", "<u2"), ("seg", "<u2"), ("off", "<u4"),\n'
        '    ("len", "<u4"),\n'
        ')\n'
    )
    ROUTE_GOOD = (
        'NET_ROUTE_FIELDS = (\n'
        '    ("ip", "<u4"), ("port", "<u2"), ("pad", "<u2"),\n'
        '    ("slot", "<i4"),\n'
        ')\n'
    )

    def test_clean_gen2_tables_pass(self, tmp_path):
        root = self._table_tree(tmp_path, self.RECV_GOOD + self.ROUTE_GOOD)
        assert _table(
            root, "NET_RECV_FIELDS", LAYOUT_RECV_FIELDS, LAYOUT_RECV_STRIDE
        ) == []
        assert _table(
            root, "NET_ROUTE_FIELDS", LAYOUT_ROUTE_FIELDS,
            LAYOUT_ROUTE_STRIDE,
        ) == []

    def test_recv_record_one_byte_drift_fires(self, tmp_path):
        # port widens u2 -> u4: off/len shift, stride 26
        root = self._table_tree(
            tmp_path,
            self.RECV_GOOD.replace('("port", "<u2")', '("port", "<u4")'),
        )
        findings = _table(
            root, "NET_RECV_FIELDS", LAYOUT_RECV_FIELDS, LAYOUT_RECV_STRIDE
        )
        assert findings, "recv-record field drift must fail lint"

    def test_route_row_field_order_drift_fires(self, tmp_path):
        # slot moves ahead of ip: same stride, different offsets
        root = self._table_tree(
            tmp_path,
            'NET_ROUTE_FIELDS = (\n'
            '    ("slot", "<i4"), ("ip", "<u4"), ("port", "<u2"),\n'
            '    ("pad", "<u2"),\n'
            ')\n',
        )
        findings = _table(
            root, "NET_ROUTE_FIELDS", LAYOUT_ROUTE_FIELDS,
            LAYOUT_ROUTE_STRIDE,
        )
        assert findings, "route-row field order drift must fail lint"

    def test_recv_stride_mirror_drift_fires(self, tmp_path):
        (tmp_path / "a.cpp").write_text(
            "constexpr size_t kRecvStride = 28;\n"
        )
        (tmp_path / "b.py").write_text("NET_RECV_STRIDE = 24\n")
        findings = same(
            "_check_mirrors",
            tmp_path, [("a.cpp", "kRecvStride", "b.py", "NET_RECV_STRIDE")]
        )
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]

    def test_send_stride_mirror_drift_fires(self, tmp_path):
        (tmp_path / "a.cpp").write_text("constexpr size_t kSendStride = 24;\n")
        (tmp_path / "b.py").write_text("NET_SEND_STRIDE = 20\n")
        findings = same(
            "_check_mirrors",
            tmp_path, [("a.cpp", "kSendStride", "b.py", "NET_SEND_STRIDE")]
        )
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]

    def test_mirror_value_drift_fires(self, tmp_path):
        (tmp_path / "a.cpp").write_text("constexpr int kX = -70;\n")
        (tmp_path / "b.py").write_text("X = -71\n")
        findings = same("_check_mirrors", tmp_path, [("a.cpp", "kX", "b.py", "X")])
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]

    def test_mirror_missing_side_fires(self, tmp_path):
        (tmp_path / "a.cpp").write_text("constexpr int kX = -70;\n")
        (tmp_path / "b.py").write_text("OTHER = 1\n")
        findings = same("_check_mirrors", tmp_path, [("a.cpp", "kX", "b.py", "X")])
        assert [f.rule for f in findings] == ["layout/mirror-missing"]


# ----------------------------------------------------------------------
# the tree itself + runtime parity
# ----------------------------------------------------------------------


class TestTreeIsClean:
    def test_repo_layout_clean(self):
        findings = check_layout(REPO)
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_mirror_table_covers_all_bank_errors(self):
        """Every kBankErr*/kHdr* the native source declares is in the
        mirror table."""
        native = parse_cpp_constants(REPO / HOST / "session_bank.cpp")
        assert native == J.parse_cpp_constants(REPO / HOST / "session_bank.cpp")
        mirrored = {
            c for f, c, _, _ in MIRRORED_CONSTANTS
            if f == f"{HOST}/session_bank.cpp"
        }
        declared = {
            k for k in native
            if k.startswith("kBankErr") or k.startswith("kHdr")
            or k.startswith("kFlag") or k.startswith("kReq")
            or k.startswith("kStage")
        } - {"kHdrStride"}  # stride is pinned by the header check
        assert declared <= mirrored, (
            f"unmirrored native constants: {sorted(declared - mirrored)}"
        )

    def test_static_header_matches_live_dtype(self):
        header = static_bank_header()
        assert header == J.static_bank_header()
        dtype = np.dtype(list(_native.BANK_HDR_FIELDS))
        assert header["stride"] == dtype.itemsize
        for name, fmt, offset in header["fields"]:
            assert dtype.fields[name][1] == offset
            assert np.dtype(fmt) == dtype.fields[name][0]
        assert tuple(dtype.names) == tuple(
            n for n, _, _ in LAYOUT_HEADER_FIELDS
        )

    def test_static_header_matches_runtime_probe(self):
        lib = _native.bank_lib()
        assert lib is not None and hasattr(lib, "ggrs_bank_hdr_stride")
        assert int(lib.ggrs_bank_hdr_stride()) == \
            static_bank_header()["stride"]

    def test_descriptor_tables_match_live_dtypes_and_probes(self):
        for fields, contract, stride in (
            (_native.BANK_REQ_FIELDS, LAYOUT_REQ_FIELDS,
             LAYOUT_REQ_STRIDE),
            (_native.BANK_STAGE_FIELDS, LAYOUT_STAGE_FIELDS,
             LAYOUT_STAGE_STRIDE),
            (_native.NET_SEND_FIELDS, LAYOUT_SEND_FIELDS,
             LAYOUT_SEND_STRIDE),
            (_native.NET_RECV_FIELDS, LAYOUT_RECV_FIELDS,
             LAYOUT_RECV_STRIDE),
            (_native.NET_ROUTE_FIELDS, LAYOUT_ROUTE_FIELDS,
             LAYOUT_ROUTE_STRIDE),
            (_native.NET_FD_FIELDS, LAYOUT_FD_FIELDS,
             LAYOUT_FD_STRIDE),
        ):
            dtype = np.dtype(list(fields))
            assert dtype.itemsize == stride
            for name, fmt, offset in contract:
                assert dtype.fields[name][1] == offset
                assert np.dtype(fmt) == dtype.fields[name][0]
        lib = _native.bank_lib()
        assert lib is not None and hasattr(lib, "ggrs_bank_req_stride")
        assert int(lib.ggrs_bank_req_stride()) == LAYOUT_REQ_STRIDE
        assert int(lib.ggrs_bank_stage_stride()) == LAYOUT_STAGE_STRIDE

    def test_gen2_tables_match_runtime_probes(self):
        lib = _native.bank_lib()
        assert lib is not None and hasattr(lib, "ggrs_net_recv_stride")
        assert int(lib.ggrs_net_recv_stride()) == LAYOUT_RECV_STRIDE
        assert int(lib.ggrs_net_route_stride()) == LAYOUT_ROUTE_STRIDE
        assert int(lib.ggrs_net_fd_stride()) == LAYOUT_FD_STRIDE
        assert int(lib.ggrs_net_send_stats_len()) == _native.NET_SEND_STATS
        assert int(lib.ggrs_net_recv_stats_len()) == \
            _native.NET_RECV_TABLE_STATS

    def test_cmd_flags_match_native_literals(self):
        native = parse_cpp_constants(REPO / HOST / "session_bank.cpp")
        assert _native.CMD_FLAG_INPUTS == native["kFlagInputs"]
        assert _native.CMD_FLAG_SKIP == native["kFlagSkip"]


class TestReviewRegressions:
    def test_enum_implicit_poisoned_after_unevaluable_entry(self):
        src = "enum { kA = sizeof(int), kB, kC, kD = 9, kE };"
        c = parse_cpp_constants(src)
        assert c == J.parse_cpp_constants(src)
        assert "kB" not in c and "kC" not in c
        assert c["kD"] == 9 and c["kE"] == 10

    def test_py_mirror_pair_drift_fires(self, tmp_path):
        (tmp_path / "a.py").write_text("P = 4\n")
        (tmp_path / "b.py").write_text("_P = 5\n")
        findings = same(
            "_check_py_mirrors", tmp_path, [("a.py", "P", "b.py", "_P")]
        )
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]

    def test_pickle_protocol_pair_is_checked_on_tree(self):
        pairs = {(a, b) for a, _, b, _ in PL.PY_MIRRORED_CONSTANTS}
        assert (
            f"{PKG}/fleet/rpc.py", f"{PKG}/parallel/host_bank.py"
        ) in pairs
        assert PL.py_mirrored_constants("ggrs_tpu") == JL.PY_MIRRORED_CONSTANTS

    def test_unsigned_complement_uses_cast_width(self):
        src = (
            "constexpr uint32_t kMask32 = ~uint32_t{0};\n"
            "constexpr uint64_t kMask64 = ~uint64_t{0};\n"
            "constexpr uint8_t kMask8 = ~uint8_t{0};\n"
        )
        c = parse_cpp_constants(src)
        assert c == J.parse_cpp_constants(src)
        assert c["kMask32"] == 0xFFFFFFFF
        assert c["kMask64"] == (1 << 64) - 1
        assert c["kMask8"] == 0xFF


# ----------------------------------------------------------------------
# §25 TCP handshake contract
# ----------------------------------------------------------------------

TP_GOOD = """\
import struct
HS_VERSION = 1
NONCE_BYTES = 16
MAC_BYTES = 32
CHALLENGE = struct.Struct("<2sBB16s")
AUTH_PREFIX = struct.Struct("<2sBBQQ16s")
AUTH = struct.Struct("<2sBBQQ16s32s")
VERDICT = struct.Struct("<2sBBQQ")
"""


class TestTcpHandshakeSkew:
    def _tree(self, tmp_path, text):
        write_both(tmp_path, "fleet/transport.py", text)
        return tmp_path

    def _check(self, root):
        return check_both("_check_tcp_handshake", root)

    def test_clean_fixture_passes(self, tmp_path):
        assert self._check(self._tree(tmp_path, TP_GOOD)) == []

    def test_auth_epoch_field_drift_fires(self, tmp_path):
        bad = TP_GOOD.replace('"<2sBBQQ16s"', '"<2sBBIQ16s"')
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/tcp-handshake" and "auth prefix" in f.detail
            for f in findings
        )

    def test_resume_cursor_drift_fires(self, tmp_path):
        bad = TP_GOOD.replace('"<2sBBQQ")', '"<2sBBQ")')
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/tcp-handshake" and "verdict" in f.detail
            for f in findings
        )

    def test_mac_tail_drift_fires(self, tmp_path):
        bad = TP_GOOD.replace('"<2sBBQQ16s32s"', '"<2sBBQQ16s16s"')
        findings = self._check(self._tree(tmp_path, bad))
        assert any("auth record" in f.detail or "mac" in f.detail
                   for f in findings)

    def test_mac_bytes_constant_drift_fires(self, tmp_path):
        bad = TP_GOOD.replace("MAC_BYTES = 32", "MAC_BYTES = 20")
        findings = self._check(self._tree(tmp_path, bad))
        assert any("MAC_BYTES" in f.detail for f in findings)

    def test_unversioned_handshake_fires(self, tmp_path):
        bad = TP_GOOD.replace("HS_VERSION = 1\n", "")
        findings = self._check(self._tree(tmp_path, bad))
        assert any("HS_VERSION" in f.detail for f in findings)

    def test_contract_matches_live_structs(self):
        from ggrs_tpu_torch.fleet import transport

        assert transport.CHALLENGE.format == PL.TCP_CHALLENGE_FMT
        assert transport.AUTH_PREFIX.format == PL.TCP_AUTH_PREFIX_FMT
        assert transport.AUTH.format == PL.TCP_AUTH_FMT
        assert transport.VERDICT.format == PL.TCP_VERDICT_FMT
        assert transport.AUTH.size == transport.AUTH_PREFIX.size + 32


# ----------------------------------------------------------------------
# §26 ingress wire contract
# ----------------------------------------------------------------------

ING_GOOD = """\
import struct
FWD_VERSION = 1
ROUTE_WIRE_VERSION = 2
ROUTE_OP_PUT = 1
ROUTE_OP_DEL = 2
FWD_HEADER = struct.Struct("<2sBBHH4s")
ROUTE_UPDATE = struct.Struct("<2sBBQQHH4s16s")
"""


class TestIngressWireSkew:
    def _tree(self, tmp_path, text):
        write_both(tmp_path, "fleet/ingress.py", text)
        return tmp_path

    def _check(self, root):
        return check_both("_check_ingress_wire", root)

    def test_clean_fixture_passes(self, tmp_path):
        assert self._check(self._tree(tmp_path, ING_GOOD)) == []

    def test_fence_word_drift_fires(self, tmp_path):
        bad = ING_GOOD.replace('"<2sBBQQHH4s16s"', '"<2sBBIQHH4s16s"')
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/ingress-wire" and "route-update" in f.detail
            for f in findings
        )

    def test_fwd_header_drift_fires(self, tmp_path):
        bad = ING_GOOD.replace('"<2sBBHH4s"', '"<2sBBH4s"')
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/ingress-wire"
            and "forwarded-datagram" in f.detail
            for f in findings
        )

    def test_unversioned_route_frame_fires(self, tmp_path):
        bad = ING_GOOD.replace("ROUTE_WIRE_VERSION = 2\n", "")
        findings = self._check(self._tree(tmp_path, bad))
        assert any("ROUTE_WIRE_VERSION" in f.detail for f in findings)

    def test_route_op_drift_fires(self, tmp_path):
        bad = ING_GOOD.replace("ROUTE_OP_DEL = 2", "ROUTE_OP_DEL = 3")
        findings = self._check(self._tree(tmp_path, bad))
        assert any("route ops" in f.detail for f in findings)

    def test_contract_matches_live_structs(self):
        from ggrs_tpu_torch.fleet import ingress

        assert ingress.FWD_HEADER.format == PL.ING_FWD_FMT
        assert ingress.ROUTE_UPDATE.format == PL.ING_ROUTE_FMT
        assert (ingress.ROUTE_UPDATE.size
                == ingress.FWD_HEADER.size + PL.ING_FENCE_BYTES
                + PL.TRACE_CTX_BYTES)


# ----------------------------------------------------------------------
# §28 trace-context contract
# ----------------------------------------------------------------------

TC_TL_GOOD = """\
import struct
TRACE_CTX_FMT = "<QII"
TRACE_CTX = struct.Struct("<QII")
TRACE_CTX_BYTES = 16
"""

TC_TP_GOOD = """\
import struct
TRACE_CTX_BYTES = 16
_TRACE = struct.Struct("<QII")
"""


class TestTraceContextSkew:
    def _tree(self, tmp_path, tl_text=TC_TL_GOOD, tp_text=TC_TP_GOOD):
        write_both(tmp_path, "obs/timeline.py", tl_text)
        write_both(tmp_path, "fleet/transport.py", tp_text)
        return tmp_path

    def _check(self, root):
        return check_both("_check_trace_context", root)

    def test_clean_fixture_passes(self, tmp_path):
        assert self._check(self._tree(tmp_path)) == []

    def test_timeline_fmt_drift_fires(self, tmp_path):
        bad = TC_TL_GOOD.replace('"<QII"', '"<QIH"')
        findings = self._check(self._tree(tmp_path, tl_text=bad))
        assert any(
            f.rule == "layout/trace-context"
            and f.path == f"{PKG}/obs/timeline.py"
            for f in findings
        )

    def test_transport_mirror_drift_fires(self, tmp_path):
        # the JAX file's fixture: TP_GOOD (the handshake module) carries no
        # trace-context struct at all, so the mirror is missing
        bad = TP_GOOD.replace('"<QII"', '"<QQ"')
        findings = self._check(self._tree(tmp_path, tp_text=bad))
        assert any(
            f.rule == "layout/trace-context"
            and f.path == f"{PKG}/fleet/transport.py"
            for f in findings
        )

    def test_byte_count_drift_fires(self, tmp_path):
        bad = TC_TL_GOOD.replace("TRACE_CTX_BYTES = 16", "TRACE_CTX_BYTES = 12")
        findings = self._check(self._tree(tmp_path, tl_text=bad))
        assert any("TRACE_CTX_BYTES" in f.detail for f in findings)

    def test_contract_matches_live_structs(self):
        from ggrs_tpu_torch.fleet import transport
        from ggrs_tpu_torch.obs import timeline

        assert timeline.TRACE_CTX.format == PL.TRACE_CTX_FMT
        assert timeline.TRACE_CTX_BYTES == PL.TRACE_CTX_BYTES == 16
        assert timeline.TRACE_CTX.size == timeline.TRACE_CTX_BYTES
        assert transport.TRACE_CTX_BYTES == PL.TRACE_CTX_BYTES
        assert PL.ING_ROUTE_FMT.endswith(f"{PL.TRACE_CTX_BYTES}s")


VARREC_GOOD = """\
import struct
VARREC_HEADER_FMT = "<H"
VARREC_HEADER_BYTES = 2
VARREC_MAX_CAPACITY = 0xFFFF
def envelope_pack(payload, capacity):
    return struct.pack("<H", len(payload)) + payload
"""

RTSCMD_GOOD = """\
from ..core.varrec import VARREC_HEADER_BYTES
CMD_BYTES = 4
"""


class TestVarrecSkew:
    def _tree(self, tmp_path, varrec_text, rtscmd_text=RTSCMD_GOOD):
        write_both(tmp_path, "core/varrec.py", varrec_text)
        write_both(tmp_path, "games/rtscmd.py", rtscmd_text)
        return tmp_path

    def _check(self, root):
        return check_both("_check_varrec", root)

    def test_clean_fixture_passes(self, tmp_path):
        assert self._check(self._tree(tmp_path, VARREC_GOOD)) == []

    def test_header_fmt_drift_fires(self, tmp_path):
        bad = VARREC_GOOD.replace('"<H"', '"<I"')
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/varrec-header"
            and "length prefix" in f.detail
            for f in findings
        )

    def test_header_width_drift_fires(self, tmp_path):
        bad = VARREC_GOOD.replace("VARREC_HEADER_BYTES = 2",
                                  "VARREC_HEADER_BYTES = 4")
        findings = self._check(self._tree(tmp_path, bad))
        assert any(
            f.rule == "layout/varrec-header"
            and "VARREC_HEADER_BYTES" in f.detail
            for f in findings
        )

    def test_capacity_bound_drift_fires(self, tmp_path):
        bad = VARREC_GOOD.replace("0xFFFF", "0x1FFFF")
        findings = self._check(self._tree(tmp_path, bad))
        assert any(f.rule == "layout/varrec-capacity" for f in findings)

    def test_consumer_literal_offset_fires(self, tmp_path):
        findings = self._check(self._tree(
            tmp_path, VARREC_GOOD,
            rtscmd_text="CMD_BYTES = 4\nHEADER = 2\n",
        ))
        assert any(f.rule == "layout/varrec-consumer" for f in findings)

    def test_contract_matches_live_module(self):
        from ggrs_tpu_torch.core import varrec

        assert varrec.VARREC_HEADER_FMT == PL.VARREC_HEADER_FMT
        assert varrec.VARREC_HEADER_BYTES == PL.VARREC_HEADER_BYTES
        assert varrec.VARREC_MAX_CAPACITY == PL.VARREC_MAX_CAPACITY
        assert varrec.envelope_size(60) == 60 + PL.VARREC_HEADER_BYTES


# ----------------------------------------------------------------------
# the port's own holds
# ----------------------------------------------------------------------

# what the port's checker adds over the JAX tree: the digest kernel lives
# only in the port, so its five mirrors find no source there
JAX_TREE_EXTRAS = [
    J.Finding(
        "layout/mirror-missing", "ggrs_tpu/csrc/digest.cu", 0,
        f"constant {c} not found (mirror of ggrs_tpu/ops/digest.py:{p})",
    )
    for c, p in (("kMaxLeaves", "MAX_LEAVES"),
                 ("kGroupMaxWords", "GROUP_MAX_WORDS"),
                 ("kSegWords", "SEG_WORDS"), ("kPrimeA", "PRIME_A"),
                 ("kPrimeB", "PRIME_B"))
]

DIGEST_MIRRORS = [
    ("kMaxLeaves", "MAX_LEAVES"), ("kGroupMaxWords", "GROUP_MAX_WORDS"),
    ("kSegWords", "SEG_WORDS"), ("kPrimeA", "PRIME_A"), ("kPrimeB", "PRIME_B"),
]


class TestSameCheckerOnTheJaxTree:
    def test_port_checker_gives_the_jax_findings(self):
        port = [tuple(f) for f in check_layout(REPO, pkg="ggrs_tpu", host=JAX_HOST)]
        jax = [tuple(f) for f in J.check_layout(REPO)]
        assert port == jax + [tuple(f) for f in JAX_TREE_EXTRAS]

    def test_tables_differ_only_in_prefix_and_the_digest_rows(self):
        jax_rows = list(JL.MIRRORED_CONSTANTS)
        assert list(PL.mirrored_constants("ggrs_tpu", JAX_HOST))[:len(jax_rows)] == jax_rows
        assert [(c, p) for _, c, _, p in MIRRORED_CONSTANTS[len(jax_rows):]] == DIGEST_MIRRORS
        for row in MIRRORED_CONSTANTS:
            assert row[0].startswith((f"{HOST}/", f"{PKG}/csrc/digest.cu"))
            assert row[2].startswith(f"{PKG}/")

    def test_contract_tables_equal_the_jax_ones(self):
        for name in ("LAYOUT_HEADER_FIELDS", "LAYOUT_STAGE_FIELDS", "LAYOUT_REQ_FIELDS",
                     "LAYOUT_SEND_FIELDS", "LAYOUT_RECV_FIELDS", "LAYOUT_ROUTE_FIELDS",
                     "LAYOUT_FD_FIELDS", "BODY_PREFIX_FMT", "RPC_HEADER_FMT",
                     "TCP_AUTH_FMT", "ING_ROUTE_FMT", "TRACE_CTX_FMT", "VARREC_HEADER_FMT"):
            assert getattr(PL, name) == getattr(JL, name), name


class TestDigestMirrors:
    def test_kernel_constants_parse_with_their_u_suffix(self):
        c = parse_cpp_constants(REPO / PKG / "csrc/digest.cu")
        assert (c["kMaxLeaves"], c["kGroupMaxWords"], c["kSegWords"]) == (32, 1024, 16384)
        assert (c["kPrimeA"], c["kPrimeB"]) == (40503, 2246822519)
        # the JAX parser drops the suffixed primes: the reason for the change
        jc = J.parse_cpp_constants(REPO / PKG / "csrc/digest.cu")
        assert "kPrimeA" not in jc and "kPrimeB" not in jc

    @pytest.mark.parametrize("literal, value", [
        ("40503u", 40503), ("40503U", 40503), ("7ul", 7), ("7UL", 7),
        ("1ull << 40", 1 << 40), ("0xFFu", 255), ("0x10ULL", 16), ("9LL", 9),
    ])
    def test_integer_suffixes(self, literal, value):
        assert parse_cpp_constants(f"constexpr uint64_t kV = {literal};\n") == {"kV": value}

    def test_identifiers_are_not_suffixes(self):
        # a name that merely ends like a suffix is not a literal
        src = "constexpr int kA = kBu;\nconstexpr int kB = 3 + ull;\n"
        assert parse_cpp_constants(src) == {}

    def test_digest_mirrors_clean_and_drift(self, tmp_path):
        mirrors = [(f"{PKG}/csrc/digest.cu", c, f"{PKG}/ops/digest.py", p)
                   for c, p in DIGEST_MIRRORS]
        assert _check_mirrors(REPO, mirrors) == []
        (tmp_path / "k.cu").write_text("constexpr unsigned kPrimeA = 40503u;\n")
        (tmp_path / "d.py").write_text("PRIME_A = 40503\n")
        assert _check_mirrors(tmp_path, [("k.cu", "kPrimeA", "d.py", "PRIME_A")]) == []
        (tmp_path / "d.py").write_text("PRIME_A = 40507\n")
        findings = _check_mirrors(tmp_path, [("k.cu", "kPrimeA", "d.py", "PRIME_A")])
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]

    def test_missing_source_file_is_a_finding_not_a_crash(self, tmp_path):
        (tmp_path / "d.py").write_text("PRIME_A = 40503\n")
        findings = _check_mirrors(tmp_path, [("k.cu", "kPrimeA", "d.py", "PRIME_A")])
        assert [(f.rule, f.path) for f in findings] == [("layout/mirror-missing", "k.cu")]


class TestNamedStructFormat:
    def test_module_constant_format_resolves(self):
        src = ('import struct\nFMT = "<H"\n'
               "def f(n, b):\n    return struct.pack(FMT, n), struct.unpack_from(FMT, b, 0)\n")
        got = {(s.func, s.fmt) for s in parse_py_struct_formats(src)}
        assert got == {("pack", "<H"), ("unpack_from", "<H")}
        assert J.parse_py_struct_formats(src) == []  # literal-only in the JAX parser

    def test_rebound_or_local_names_do_not_resolve(self):
        src = ('import struct\nFMT = "<H"\nFMT = "<I"\nLOCAL = 3\n'
               'def f(n):\n    fmt = "<Q"\n    return struct.pack(FMT, n), struct.pack(fmt, n)\n')
        assert parse_py_struct_formats(src) == []

    def test_port_varrec_packs_through_the_named_constant(self):
        fmts = parse_py_struct_formats(REPO / PKG / "core/varrec.py")
        assert {f.fmt for f in fmts} == {PL.VARREC_HEADER_FMT}
        assert PL._check_varrec(REPO) == []

    def test_named_format_drift_fires(self, tmp_path):
        text = VARREC_GOOD.replace('struct.pack("<H", len(payload))',
                                   "struct.pack(VARREC_HEADER_FMT, len(payload))")
        root = tmp_path
        for rel, body in (("core/varrec.py", text), ("games/rtscmd.py", RTSCMD_GOOD)):
            (root / PKG / rel).parent.mkdir(parents=True, exist_ok=True)
            (root / PKG / rel).write_text(body)
        assert PL._check_varrec(root) == []
        (root / PKG / "core/varrec.py").write_text(text.replace('"<H"', '"<I"'))
        assert any(f.rule == "layout/varrec-header" and "length prefix" in f.detail
                   for f in PL._check_varrec(root))


@pytest.fixture(scope="module")
def tree_copy(tmp_path_factory):
    """A copy of the port's tree (its host sources included)."""
    root = tmp_path_factory.mktemp("port_tree")
    shutil.copytree(REPO / PKG, root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert check_layout(root) == []
    return root


def _mutated(root, rel, old, new):
    path = root / rel
    text = path.read_text()
    assert text.count(old) == 1, old
    path.write_text(text.replace(old, new))
    try:
        return check_layout(root)
    finally:
        path.write_text(text)


class TestMutations:
    @pytest.mark.parametrize("old, new, name", [
        ("constexpr int kMaxLeaves = 32;", "constexpr int kMaxLeaves = 33;", "MAX_LEAVES"),
        ("constexpr long long kGroupMaxWords = 1024;",
         "constexpr long long kGroupMaxWords = 2048;", "GROUP_MAX_WORDS"),
        ("constexpr long long kSegWords = 16384;",
         "constexpr long long kSegWords = 8192;", "SEG_WORDS"),
        ("constexpr unsigned kPrimeA = 40503u;", "constexpr unsigned kPrimeA = 40507u;", "PRIME_A"),
        ("constexpr unsigned kPrimeB = 2246822519u;",
         "constexpr unsigned kPrimeB = 2246822517u;", "PRIME_B"),
    ])
    def test_kernel_side_drift_fires(self, tree_copy, old, new, name):
        findings = _mutated(tree_copy, f"{PKG}/csrc/digest.cu", old, new)
        assert [(f.rule, f.path) for f in findings] == [
            ("layout/mirror-mismatch", f"{PKG}/ops/digest.py")]
        assert findings[0].detail.startswith(f"{name} = ")

    def test_wrapper_side_drift_fires(self, tree_copy):
        findings = _mutated(tree_copy, f"{PKG}/ops/digest.py",
                            "SEG_WORDS = 16384", "SEG_WORDS = 16385")
        assert [f.rule for f in findings] == ["layout/mirror-mismatch"]
        assert "kSegWords = 16384" in findings[0].detail

    def test_named_varrec_format_drift_fires(self, tree_copy):
        findings = _mutated(tree_copy, f"{PKG}/core/varrec.py",
                            'VARREC_HEADER_FMT = "<H"', 'VARREC_HEADER_FMT = "<I"')
        assert [f.rule for f in findings] == ["layout/varrec-header"]

    def test_port_bank_header_drift_fires(self, tree_copy):
        findings = _mutated(tree_copy, f"{PKG}/net/_native.py",
                            '("err", "<i4")', '("err", "<i2")')
        assert findings and all(f.path == f"{PKG}/net/_native.py" for f in findings)
