"""FITS persistence.

The reference saves results as a FITS primary HDU with a ~25-key header via
astropy (``fast/fast.py:771-812``, ``fast/fast.py:998-1002``). astropy is a
heavyweight dependency for that one feature, so this module implements the
small subset of the format we need (single primary image HDU, 80-character
cards, 2880-byte blocks) in pure Python, delegating to astropy when it is
importable so files remain bit-compatible with reference tooling.
"""

import numpy as np

try:  # pragma: no cover - exercised only when astropy is installed
    from astropy.io import fits as _astropy_fits
except ImportError:
    _astropy_fits = None

_BLOCK = 2880

_BITPIX = {
    np.dtype(">f8"): -64, np.dtype(">f4"): -32,
    np.dtype(">i8"): 64, np.dtype(">i4"): 32, np.dtype(">i2"): 16,
    np.dtype("uint8"): 8,
}


class Header(dict):
    """Ordered FITS header; supports item assignment like astropy's."""


def _format_value(value):
    if isinstance(value, bool):
        return "T" if value else "F"
    if isinstance(value, str):
        v = value.replace("'", "''")
        return "'%-8s'" % v
    if value is None:
        return ""
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    v = float(value)
    if np.isinf(v):
        return "'inf'" if v > 0 else "'-inf'"
    return repr(v)

def _card(key, value):
    key = str(key).upper()[:8]
    val = _format_value(value)
    card = "%-8s= %20s" % (key, val)
    return card[:80].ljust(80)


def _parse_value(raw):
    raw = raw.strip()
    if raw.startswith("'"):
        return raw[1:raw.rindex("'")].rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def writeto(fname, data, header=None, overwrite=False, **kwargs):
    """Write ``data`` (+ header cards) as a primary FITS HDU."""
    if _astropy_fits is not None:
        hdr = _astropy_fits.Header()
        for k, v in (header or {}).items():
            hdr[k] = v
        _astropy_fits.writeto(fname, np.asarray(data), header=hdr,
                              overwrite=overwrite, **kwargs)
        return

    data = np.asarray(data)
    if np.iscomplexobj(data):
        raise TypeError("FITS images cannot store complex data")
    out = data.astype(">f8") if data.dtype.kind == "f" else data.astype(">i8")
    bitpix = _BITPIX[out.dtype]

    cards = ["%-8s= %20s" % ("SIMPLE", "T"),
             "%-8s= %20d" % ("BITPIX", bitpix),
             "%-8s= %20d" % ("NAXIS", out.ndim)]
    for i, n in enumerate(reversed(out.shape)):
        cards.append("%-8s= %20d" % ("NAXIS%d" % (i + 1), n))
    for k, v in (header or {}).items():
        cards.append(_card(k, v))
    cards.append("END")
    hdr_bytes = "".join(c.ljust(80) for c in cards).encode("ascii")
    hdr_bytes += b" " * (-len(hdr_bytes) % _BLOCK)

    payload = out.tobytes()
    payload += b"\0" * (-len(payload) % _BLOCK)

    mode = "wb" if overwrite else "xb"
    with open(fname, mode) as f:
        f.write(hdr_bytes)
        f.write(payload)


def _read(fname):
    with open(fname, "rb") as f:
        raw = f.read()
    header = Header()
    pos = 0
    while True:
        block = raw[pos:pos + _BLOCK].decode("ascii", errors="replace")
        pos += _BLOCK
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if not key or key in ("COMMENT", "HISTORY") or card[8:10] != "= ":
                continue
            header[key] = _parse_value(card[10:].split(" /")[0])
        if done or pos >= len(raw):
            break
    bitpix = header["BITPIX"]
    naxis = header["NAXIS"]
    shape = tuple(header["NAXIS%d" % i] for i in range(naxis, 0, -1))
    dtype = {8: "u1", 16: ">i2", 32: ">i4", 64: ">i8",
             -32: ">f4", -64: ">f8"}[bitpix]
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw[pos:], dtype=dtype, count=count).reshape(shape)
    return header, data.copy()  # writable, native-order copy


def getheader(fname):
    if _astropy_fits is not None:
        return _astropy_fits.getheader(fname)
    return _read(fname)[0]


def getdata(fname):
    if _astropy_fits is not None:
        return _astropy_fits.getdata(fname)
    return _read(fname)[1]
