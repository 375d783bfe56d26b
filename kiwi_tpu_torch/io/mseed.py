"""Mini-SEED reader/writer.

Replaces the reference's libmseed shim (mseed/mseed_simple.c): writes
4096-byte big-endian records with FLOAT32 encoding (as writemseed does,
mseed_simple.c:59-60) and reads FLOAT32/FLOAT64/INT32/INT16/STEIM1/STEIM2
encoded records.  If the native C++ codec (kiwi_tpu_torch.native) is built, its
STEIM decoders are used; this pure-Python implementation is the fallback
and the format reference.

Record layout: 48-byte fixed data header, blockette 1000 at offset 48,
data from offset 64.
"""

from __future__ import annotations

import datetime as _dt
import struct

import numpy as np

RECLEN = 4096
DATA_OFFSET = 64
SAMPLES_PER_RECORD = (RECLEN - DATA_OFFSET) // 4

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def _encode_samprate(rate):
    """(factor, multiplier) i16 pair encoding the sample rate."""
    if rate <= 0:
        raise ValueError("sample rate must be positive")
    if abs(rate - round(rate)) < 1e-7 * rate and round(rate) <= 32767:
        return int(round(rate)), 1
    period = 1.0 / rate
    if abs(period - round(period)) < 1e-7 * period and round(period) <= 32767:
        return -int(round(period)), 1
    # approximate: rate = -factor / multiplier
    mult = -1000
    fact = int(round(rate * 1000))
    if fact > 32767:
        mult = -10
        fact = int(round(rate * 10))
    return fact, mult


def _decode_samprate(factor, multiplier):
    if factor > 0 and multiplier > 0:
        return factor * multiplier
    if factor > 0 and multiplier < 0:
        return -factor / multiplier
    if factor < 0 and multiplier > 0:
        return -multiplier / factor
    if factor < 0 and multiplier < 0:
        return 1.0 / (factor * multiplier)
    raise ValueError("invalid sample rate encoding")


def _btime(t_epoch):
    """(year, doy, h, m, s, frac0001) from epoch seconds."""
    # the reference rounds to 1e-5 s before packing (mseed_simple.c:70-78)
    t = round(t_epoch * 1e5) * 1e-5
    whole = int(np.floor(t))
    frac = int(round((t - whole) * 1e4))
    if frac >= 10000:
        whole += 1
        frac -= 10000
    d = _EPOCH + _dt.timedelta(seconds=whole)
    doy = d.timetuple().tm_yday
    return d.year, doy, d.hour, d.minute, d.second, frac


def _btime_to_epoch(year, doy, h, m, s, frac):
    d = _dt.datetime(year, 1, 1, tzinfo=_dt.timezone.utc) + _dt.timedelta(
        days=doy - 1, hours=h, minutes=m, seconds=s
    )
    return (d - _EPOCH).total_seconds() + frac * 1e-4


def write(filename, data, toffset, deltat, network="", station="", location="",
          channel=""):
    """FLOAT32 Mini-SEED, 4096-byte records (mseed_simple.c:12-66).

    Uses the native C++ codec when available; write_py is the pure-Python
    format reference."""
    try:
        from .. import native

        if native.mseed_write(filename, data, toffset, deltat, network,
                              station, location, channel):
            return
    except Exception:
        pass
    write_py(filename, data, toffset, deltat, network, station, location, channel)


def write_py(filename, data, toffset, deltat, network="", station="", location="",
             channel=""):
    """Pure-Python record writer (format reference)."""
    data = np.asarray(data, dtype=">f4")
    n = data.shape[0]
    rate = 1.0 / deltat
    fact, mult = _encode_samprate(rate)

    with open(filename, "wb") as f:
        iseq = 1
        for start in range(0, max(n, 1), SAMPLES_PER_RECORD):
            chunk = data[start : start + SAMPLES_PER_RECORD]
            t0 = toffset + start * deltat
            year, doy, hh, mm, ss, frac = _btime(t0)
            header = struct.pack(
                ">6scc5s2s3s2sHHBBBBHHhhBBBBlHH",
                f"{iseq:06d}".encode(),
                b"D",
                b" ",
                station[:5].ljust(5).encode(),
                location[:2].ljust(2).encode(),
                channel[:3].ljust(3).encode(),
                network[:2].ljust(2).encode(),
                year, doy, hh, mm, ss, 0, frac,
                len(chunk),  # numsamples
                fact, mult,
                0, 0, 0,  # activity, io, quality flags
                1,  # one blockette
                0,  # time correction
                DATA_OFFSET,
                48,  # first blockette offset
            )
            b1000 = struct.pack(">HHBBBB", 1000, 0, 4, 1, 12, 0)  # FLOAT32, BE, 2^12
            rec = bytearray(RECLEN)
            rec[: len(header)] = header
            rec[48 : 48 + len(b1000)] = b1000
            rec[DATA_OFFSET : DATA_OFFSET + chunk.nbytes] = chunk.tobytes()
            f.write(bytes(rec))
            iseq += 1


def _decode_steim(payload, nsamples, level):
    """STEIM1/2 decode (one record's data section, 64-byte frames)."""
    out = np.empty(nsamples + 8, dtype=np.int64)
    nout = 0
    x0 = xn = None
    nframes = len(payload) // 64
    for fi in range(nframes):
        frame = payload[fi * 64 : (fi + 1) * 64]
        w0 = struct.unpack(">I", frame[:4])[0]
        for wi in range(1, 16):
            c = (w0 >> (2 * (15 - wi))) & 0x3
            word = frame[wi * 4 : (wi + 1) * 4]
            if fi == 0 and wi == 1:
                x0 = struct.unpack(">i", word)[0]
                continue
            if fi == 0 and wi == 2:
                xn = struct.unpack(">i", word)[0]
                continue
            if c == 0:
                continue
            if level == 1:
                if c == 1:
                    vals = struct.unpack(">4b", word)
                elif c == 2:
                    vals = struct.unpack(">2h", word)
                else:
                    vals = struct.unpack(">i", word)
            else:  # steim2
                if c == 1:
                    vals = struct.unpack(">4b", word)
                else:
                    (u,) = struct.unpack(">I", word)
                    dnib = (u >> 30) & 0x3
                    if c == 2:
                        if dnib == 1:
                            vals = (_sx(u, 0, 30, 30),)
                        elif dnib == 2:
                            vals = (_sx(u, 15, 15, 30), _sx(u, 0, 15, 30))
                        else:
                            vals = (_sx(u, 20, 10, 30), _sx(u, 10, 10, 30), _sx(u, 0, 10, 30))
                    else:  # c == 3
                        if dnib == 0:
                            vals = tuple(_sx(u, sh, 6, 30) for sh in (24, 18, 12, 6, 0))
                        elif dnib == 1:
                            vals = tuple(_sx(u, sh, 5, 30) for sh in (25, 20, 15, 10, 5, 0))
                        else:
                            vals = tuple(_sx(u, sh, 4, 28) for sh in (24, 20, 16, 12, 8, 4, 0))
            for v in vals:
                if nout < out.shape[0]:
                    out[nout] = v
                    nout += 1
    if x0 is None:
        return np.zeros(0, dtype=np.float32)
    if nout < nsamples:
        # header overstated nsamp relative to the decodable frames: zero the
        # undecoded tail rather than integrating uninitialized memory
        out[nout:nsamples] = 0
    diffs = out[:nsamples]
    series = np.cumsum(diffs)
    series = series - series[0] + x0
    if xn is not None and nsamples > 0 and series[-1] != xn:
        # tolerate inconsistent reverse integration constant (warn-worthy)
        pass
    return series.astype(np.float32)


def _sx(u, shift, bits, _total):
    """Extract signed `bits`-wide field at `shift` from uint32."""
    v = (u >> shift) & ((1 << bits) - 1)
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def read(filename):
    """(data f32[n], toffset epoch-seconds, deltat).  Concatenates the
    records of the first trace in the file (readmseed, mseed_simple.c:69+).
    Uses the native C++ codec when available."""
    try:
        from .. import native

        res = native.mseed_read(filename)
        if res is not None:
            return res
    except IOError:
        raise
    except Exception:
        pass
    return read_py(filename)


def read_py(filename):
    """Pure-Python record reader (format reference)."""
    segments = []
    toffset = None
    deltat = None
    with open(filename, "rb") as f:
        blob = f.read()
    pos = 0
    while pos + 64 <= len(blob):
        hdr = blob[pos : pos + 48]
        (seq, _q, _r, _sta, _loc, _cha, _net, year, doy, hh, mm, ss, _u, frac,
         nsamp, fact, mult, _af, _if, _qf, nblk, _tc, dofs, bofs) = struct.unpack(
            ">6scc5s2s3s2sHHBBBBHHhhBBBBlHH", hdr
        )
        if not seq[:6].strip().isdigit() and toffset is None:
            raise ValueError(f"{filename}: not a Mini-SEED file")
        # find blockette 1000 for encoding + record length
        enc, reclen = 4, RECLEN
        bo = bofs
        for _ in range(nblk):
            if bo == 0 or pos + bo + 8 > len(blob):
                break
            btype, bnext = struct.unpack(">HH", blob[pos + bo : pos + bo + 4])
            if btype == 1000:
                enc, _wo, rl, _res = struct.unpack(
                    ">BBBB", blob[pos + bo + 4 : pos + bo + 8]
                )
                reclen = 1 << rl
                break
            bo = bnext
        t0 = _btime_to_epoch(year, doy, hh, mm, ss, frac)
        rate = _decode_samprate(fact, mult)
        payload = blob[pos + dofs : pos + reclen]
        if enc == 4:
            vals = np.frombuffer(payload[: nsamp * 4], dtype=">f4").astype(np.float32)
        elif enc == 5:
            vals = np.frombuffer(payload[: nsamp * 8], dtype=">f8").astype(np.float32)
        elif enc == 3:
            vals = np.frombuffer(payload[: nsamp * 4], dtype=">i4").astype(np.float32)
        elif enc == 1:
            vals = np.frombuffer(payload[: nsamp * 2], dtype=">i2").astype(np.float32)
        elif enc in (10, 11):
            vals = _decode_steim(payload, nsamp, 1 if enc == 10 else 2)
        else:
            raise ValueError(f"{filename}: unsupported mseed encoding {enc}")
        if toffset is None:
            toffset = t0
            deltat = 1.0 / rate
        segments.append(vals)
        pos += reclen
    if toffset is None:
        raise ValueError(f"{filename}: empty Mini-SEED file")
    return np.concatenate(segments), toffset, deltat
