"""CLI surface tests (the reference's executable entry points,
PARITY.md section 2.1)."""

import json
import sys

import numpy as np
import pytest

from wrp_tpu import cli


def test_process_synthetic_writes_result(tmp_path, capsys):
    out = tmp_path / "res.out"
    rc = cli.main(["process", "--input", "synthetic", "--method", "mxu",
                   "--output", str(out)])
    assert rc == 0
    rows = np.loadtxt(out)
    assert rows.shape[1] == 2          # zdb zdr columns (99result format)
    assert rows[0, 0] == -np.inf       # range bin 0 is always -inf
    assert np.isfinite(rows[1:, 0]).all()


def test_process_dump_stages(tmp_path):
    dumps = tmp_path / "dumps"
    rc = cli.main(["process", "--input", "synthetic", "--method", "mxu",
                   "--dump-stages", str(dumps), "--output",
                   str(tmp_path / "r.out")])
    assert rc == 0
    names = sorted(p.name for p in dumps.iterdir())
    # the full staged-golden set the reference's methodology used
    assert names == ["00iq.altb", "01hamm.altb", "02fft1.altb",
                     "03fft2.altb", "04abs.altb", "07conv.altb",
                     "08pow.altb", "09zdb.altb", "10zdr.altb"]


def test_compare_reference_golden(capsys, reference_dir):
    import os

    golden = os.path.join(reference_dir, "out/99result.cpu.out")
    rc = cli.main(["compare", golden, golden, "--threshold", "1e-9"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pass"] and out["relative_l2"] == 0.0


def test_compare_shape_mismatch(tmp_path, capsys):
    a = tmp_path / "a.out"
    b = tmp_path / "b.out"
    a.write_text("1 2\n3 4\n")
    b.write_text("1 2\n")
    assert cli.main(["compare", str(a), str(b)]) == 2


def test_compare_failing_threshold(tmp_path, capsys):
    a = tmp_path / "a.out"
    b = tmp_path / "b.out"
    a.write_text("1.0\n2.0\n")
    b.write_text("1.5\n2.5\n")
    assert cli.main(["compare", str(a), str(b), "--threshold", "1e-6"]) == 1


def test_volume_inspect_and_export(tmp_path, capsys):
    from wrp_tpu.config import tiny_config
    from wrp_tpu.runtime import VolumeScan

    cfg = tiny_config(m=16, n=8)
    vs = VolumeScan(cfg, tmp_path / "v.npz")
    vs.store(0, 0, np.arange(8, dtype=np.float32),
             np.full(8, 2.5, dtype=np.float32))
    vs.save()

    import json as json_mod

    # checkpoints are self-describing: no config needed to inspect them
    rc = cli.main(["volume", str(tmp_path / "v.npz"),
                   "--export", str(tmp_path / "e.npz")])
    assert rc == 0
    info = json_mod.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["sectors_covered"] == 1 and not info["complete"]
    # both products summarised (round-1 VERDICT: zdr had no stats)
    assert info["zdb_max"] == 7.0
    assert info["zdr_mean"] == 2.5
    dumped = np.load(tmp_path / "e.npz")
    assert dumped["zdb"].shape == (cfg.num_output_bins, cfg.num_sectors,
                                   cfg.num_elevations)


def test_volume_export_ascii_reference_format(tmp_path, capsys):
    """`volume --export-ascii` writes one 99result-format file per
    covered sector (the reference's out/99result.*.out layout), so
    reference-era tooling and `cli compare` consume framework volumes
    directly — including -inf bins, which the comparator skips."""
    from wrp_tpu.config import tiny_config
    from wrp_tpu.io.files import read_result_file
    from wrp_tpu.runtime import VolumeScan

    cfg = tiny_config(m=16, n=8)
    vs = VolumeScan(cfg, tmp_path / "v.npz")
    zdb = np.arange(8, dtype=np.float32)
    zdb[0] = -np.inf                      # bin 0 is always -inf (z[0]=0)
    vs.store(5, 1, zdb, np.full(8, 2.5, dtype=np.float32))
    vs.store(7, 0, zdb + 1, np.full(8, 3.5, dtype=np.float32))
    vs.save()

    outdir = tmp_path / "ascii"
    rc = cli.main(["volume", str(tmp_path / "v.npz"),
                   "--export-ascii", str(outdir)])
    assert rc == 0
    files = sorted(p.name for p in outdir.iterdir())
    assert files == ["s005e1.out", "s007e0.out"]
    got_zdb, got_zdr = read_result_file(outdir / "s005e1.out")
    assert got_zdb[0] == -np.inf          # -inf survives the round trip
    np.testing.assert_allclose(got_zdb[1:], zdb[1:], rtol=1e-5)
    np.testing.assert_allclose(got_zdr, 2.5)
    # the exported file IS comparable with the reference comparator CLI
    assert cli.main(["compare", str(outdir / "s005e1.out"),
                     str(outdir / "s005e1.out")]) == 0


def test_process_ascii_stdin_read_cc_format(tmp_path, monkeypatch):
    """P1 parity (read.cc:106-123): a reference-era ASCII IQ capture —
    "<i> <q>" pairs, all hh then all vv — replayed on stdin produces
    99result-format output matching the fp64 oracle."""
    import dataclasses
    import io

    from wrp_tpu import oracle
    from wrp_tpu.config import DEFAULT_CONFIG
    from wrp_tpu.io.files import write_ascii_iq

    cfg2 = dataclasses.replace(DEFAULT_CONFIG, num_channels=2)
    iq = oracle.synthetic_iq(cfg2, kind="noise", seed=7)
    buf = io.StringIO()
    write_ascii_iq(buf, iq)
    monkeypatch.setattr(sys, "stdin", io.StringIO(buf.getvalue()))

    out = tmp_path / "res.out"
    rc = cli.main(["process", "--input", "-", "--method", "mxu",
                   "--output", str(out)])
    assert rc == 0
    rows = np.loadtxt(out)
    zdb64, zdr64 = oracle.process_sector(iq, cfg2)
    assert oracle.relative_l2(zdb64, rows[:, 0]) < 1e-6
    assert oracle.relative_l2(zdr64, rows[:, 1]) < 1e-4


def test_ascii_iq_roundtrip_and_size_check(tmp_path):
    import io

    from wrp_tpu.io.files import read_ascii_iq, write_ascii_iq

    rng = np.random.default_rng(3)
    iq = (rng.standard_normal((2, 4, 6)) + 1j * rng.standard_normal((2, 4, 6)))
    buf = io.StringIO()
    write_ascii_iq(buf, iq)
    back = read_ascii_iq(io.StringIO(buf.getvalue()), 4, 6, channels=2)
    np.testing.assert_allclose(back, iq, rtol=1e-5)
    with pytest.raises(ValueError):
        read_ascii_iq(io.StringIO("1 2 3"), 4, 6, channels=2)


def test_viz_render_ppi_and_ppm(tmp_path):
    """PPI rendering of a volume cut: covered sectors colored, uncovered
    and non-finite cells black, valid P6 output."""
    from wrp_tpu import viz

    bins, sectors = 32, 16
    field = np.full((bins, sectors), np.nan, np.float32)
    field[:, :8] = np.linspace(0, 60, bins)[:, None]   # half the disc covered
    field[0, :] = -np.inf                              # range bin 0
    img = viz.render_ppi(field, size=64)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    # east half (covered sectors 0..7 span north->south clockwise) colored
    assert img[32, 48].any()      # east: covered
    assert not img[32, 8].any()   # west: uncovered -> black
    assert not img[0, 0].any()    # corner outside the disc -> black
    p = viz.write_ppm(tmp_path / "ppi.ppm", img)
    raw = p.read_bytes()
    assert raw.startswith(b"P6\n64 64\n255\n")
    assert len(raw) == raw.index(b"255\n") + 4 + 64 * 64 * 3


def test_cli_volume_render(tmp_path, capsys):
    from wrp_tpu.config import tiny_config
    from wrp_tpu.runtime import VolumeScan

    cfg = tiny_config(m=16, n=8)
    vs = VolumeScan(cfg, tmp_path / "v.npz")
    for s in range(cfg.num_sectors):
        vs.store(s, 0, np.linspace(0, 50, 8).astype(np.float32),
                 np.zeros(8, np.float32))
    vs.save()
    out = tmp_path / "ppi.ppm"
    rc = cli.main(["volume", str(tmp_path / "v.npz"),
                   "--render", str(out), "--product", "zdb"])
    assert rc == 0
    assert out.read_bytes().startswith(b"P6\n512 512\n255\n")


def test_cli_volume_render_all_mosaic(tmp_path):
    """--render-all tiles every elevation cut into one mosaic with a
    shared color scale; covered cuts show color, untouched cuts stay
    black."""
    from wrp_tpu import viz
    from wrp_tpu.config import tiny_config
    from wrp_tpu.runtime import VolumeScan

    cfg = tiny_config(m=16, n=8)       # 2 elevation cuts
    vs = VolumeScan(cfg, tmp_path / "v.npz")
    for s in range(cfg.num_sectors):   # only elevation 0 covered
        vs.store(s, 0, np.linspace(0, 50, 8).astype(np.float32),
                 np.zeros(8, np.float32))
    vs.save()
    out = tmp_path / "mosaic.ppm"
    rc = cli.main(["volume", str(tmp_path / "v.npz"),
                   "--render-all", str(out), "--render-size", "64"])
    assert rc == 0
    img_bytes = out.read_bytes()
    assert img_bytes.startswith(b"P6\n")
    # direct API check: cut 0 colored, cut 1 (uncovered) black
    mosaic = viz.render_volume_mosaic(np.asarray(vs.data[0]), vs.coverage,
                                      size=64, cols=2, pad=2)
    cut0 = mosaic[2:66, 2:66]
    cut1 = mosaic[2:66, 68:132]
    assert cut0.any()
    assert not cut1.any()


def _free_udp_ports(count):
    """Ports of this test's own: the config's default result ports are
    shared with every stream another test worker runs."""
    import socket

    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
             for _ in range(count)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cli_consume_accumulates_volume(tmp_path, monkeypatch, capsys):
    """consume --volume: received zdb+zdr frames become a renderable
    volume checkpoint (the consumer as a display endpoint, not a print
    stub).  Uses the UDP v1 wire over loopback."""
    import socket
    import threading

    from wrp_tpu.config import DEFAULT_CONFIG
    from wrp_tpu.io import frames
    from wrp_tpu.runtime import VolumeScan

    cfg = DEFAULT_CONFIG
    k = cfg.num_output_bins
    zdb_port, zdr_port = _free_udp_ports(2)

    def send():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for sec in (3, 7):
            zdb = np.full(k, 30.0 + sec, np.float32)
            zdr = np.full(k, 0.5, np.float32)
            s.sendto(frames.pack_result_v1(sec, zdb),
                     ("127.0.0.1", zdb_port))
            s.sendto(frames.pack_result_v1(sec, zdr),
                     ("127.0.0.1", zdr_port))
        s.close()

    t = threading.Timer(0.5, send)
    t.start()
    vol = tmp_path / "rx.npz"
    rc = cli.main(["consume", "--transport", "udp", "--count", "2",
                   "--timeout", "5", "--volume", str(vol),
                   "--port", str(zdb_port), "--zdr-port", str(zdr_port)])
    t.join()
    assert rc == 0
    vs = VolumeScan.load(vol)
    assert vs.coverage[3, 0] and vs.coverage[7, 0]
    assert int(vs.coverage.sum()) == 2
    np.testing.assert_allclose(vs.data[0, :, 3, 0], 33.0)
    np.testing.assert_allclose(vs.data[1, :, 7, 0], 0.5)
    # and it renders
    out = tmp_path / "rx.ppm"
    assert cli.main(["volume", str(vol), "--render", str(out)]) == 0
    assert out.read_bytes().startswith(b"P6\n")


def test_cli_produce_replays_ascii_capture(tmp_path, monkeypatch, capsys):
    """produce --input replays a read.cc-format capture onto the wire:
    what arrives decodes back to the recorded hh/vv samples (vh zero)."""
    import threading

    from wrp_tpu.config import DEFAULT_CONFIG
    from wrp_tpu.io import codec
    from wrp_tpu.io.files import write_ascii_iq
    from wrp_tpu.io.udp import UdpIngest

    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(9)
    iq2 = (rng.integers(-8192, 8192, (2, cfg.m, cfg.n))
           + 1j * rng.integers(-8192, 8192, (2, cfg.m, cfg.n))).astype(
        np.complex128)
    cap = tmp_path / "cap.altb"
    with open(cap, "w") as f:
        write_ascii_iq(f, iq2)

    ingest = UdpIngest(cfg, port=0, timeout_s=10.0)
    result = {}

    def rx():
        wire, hdr = ingest.recv_sector()
        result["planar"] = codec.decode_iq(bytes(wire), cfg)

    t = threading.Thread(target=rx)
    t.start()
    rc = cli.main(["produce", "--transport", "udp", "--sectors", "1",
                   "--ingest-port", str(ingest.local_port),
                   "--input", str(cap)])
    t.join(timeout=30)
    ingest.close()
    assert rc == 0 and "planar" in result
    planar = result["planar"]          # [C, 2, m, n] float32
    np.testing.assert_array_equal(planar[0, 0], iq2[0].real)
    np.testing.assert_array_equal(planar[1, 1], iq2[1].imag)
    assert not planar[2].any()         # vh padded with zeros


def test_cli_consume_survives_runt_datagram(tmp_path):
    """A malformed (runt) result datagram must be skipped, not crash the
    consumer and lose the --volume accumulation."""
    import socket
    import threading

    from wrp_tpu.config import DEFAULT_CONFIG
    from wrp_tpu.io import frames
    from wrp_tpu.runtime import VolumeScan

    cfg = DEFAULT_CONFIG
    k = cfg.num_output_bins
    zdb_port, zdr_port = _free_udp_ports(2)

    def send():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"\x01", ("127.0.0.1", zdb_port))      # runt
        s.sendto(frames.pack_result_v1(2, np.full(k, 9.0, np.float32)),
                 ("127.0.0.1", zdb_port))
        s.sendto(frames.pack_result_v1(2, np.full(k, 0.25, np.float32)),
                 ("127.0.0.1", zdr_port))
        s.close()

    threading.Timer(0.5, send).start()
    vol = tmp_path / "rx.npz"
    rc = cli.main(["consume", "--transport", "udp", "--count", "1",
                   "--timeout", "5", "--volume", str(vol),
                   "--port", str(zdb_port), "--zdr-port", str(zdr_port)])
    assert rc == 0
    vs = VolumeScan.load(vol)
    assert vs.coverage[2, 0]


def test_cli_consume_accumulates_volume_zmq(tmp_path):
    """consume --volume over the v2 ZMQ wire: topic-B/C frames carry
    sector AND elevation, so accumulation lands on the right cut."""
    pytest.importorskip("zmq")
    import socket
    import threading
    import time

    from wrp_tpu.config import DEFAULT_CONFIG
    from wrp_tpu.io.zmq_io import ZmqEgress
    from wrp_tpu.runtime import VolumeScan

    cfg = DEFAULT_CONFIG
    k = cfg.num_output_bins

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    egress = ZmqEgress(cfg, endpoint=f"tcp://127.0.0.1:{port}")

    def send():
        time.sleep(0.8)  # PUB/SUB join
        egress.send(5, 3, np.full(k, 40.0, np.float32),
                    np.full(k, 1.5, np.float32))

    threading.Thread(target=send, daemon=True).start()
    vol = tmp_path / "rxz.npz"
    rc = cli.main(["consume", "--transport", "zmq", "--count", "2",
                   "--timeout", "6", "--volume", str(vol),
                   "--zmq-sub", f"tcp://127.0.0.1:{port}"])
    egress.close()
    assert rc == 0
    vs = VolumeScan.load(vol)
    assert vs.coverage[5, 3]
    np.testing.assert_allclose(vs.data[0, :, 5, 3], 40.0)
    np.testing.assert_allclose(vs.data[1, :, 5, 3], 1.5)
