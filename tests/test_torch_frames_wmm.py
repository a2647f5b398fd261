"""The port's epochs, IERS data, ECI frames and World Magnetic Model against
the JAX package's (``elodin_tpu_torch/{frames,wmm}.py`` against
``elodin_tpu/{frames,wmm}.py``), then the goldens of
``tests/test_frames_wmm.py`` on the port.

The time and ECI functions are host numpy in both packages: they must be
equal bit for bit, over seeded epochs from 1990 to 2040, with IERS data
read from a small ``finals2000A.data`` that the test writes and with none.
``wmm`` is torch against JAX: max |Δ| / max |ref| ≤ 1e-12 per output over
seeded batches (lat, long, alt, year), the poles included, where
``field_spherical``'s ``st_safe`` applies.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elodin_tpu import frames as jframes
from elodin_tpu import wmm as jwmm
from elodin_tpu_torch import frames, wmm
from test_frames_wmm import REF_IERS
from torch_port_util import rel_err

TOL = 1e-12
N_EPOCHS = 64


def _epochs(seed=0):
    """Seeded UTC epochs from 1990 to 2040, as (year, month, day, hour,
    minute, second, nanos) tuples."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_EPOCHS):
        out.append((int(rng.integers(1990, 2041)), int(rng.integers(1, 13)),
                    int(rng.integers(1, 29)), int(rng.integers(0, 24)),
                    int(rng.integers(0, 60)), float(rng.uniform(0.0, 60.0)),
                    int(rng.integers(0, 10**9))))
    return out


def _finals_line(mjd, pm_x, pm_y, dut1, dx=None, dy=None) -> str:
    """One row in the fixed-width ``finals2000A.data`` columns that
    ``IERS._load`` reads: MJD [7:15], PM-x [18:27], PM-y [37:46], UT1-UTC
    [58:68], dX [97:106] and dY [116:125] (mas); no dX/dY without them."""
    row = [" "] * 188
    for start, text in ((7, f"{mjd:8.2f}"), (18, f"{pm_x:9.6f}"), (37, f"{pm_y:9.6f}"),
                        (58, f"{dut1:10.7f}")):
        row[start:start + len(text)] = text
    if dx is not None:
        for start, text in ((97, f"{dx:9.3f}"), (116, f"{dy:9.3f}")):
            row[start:start + len(text)] = text
    return "".join(row[:125] if dx is not None else row[:70]).rstrip() + "\n"


@pytest.fixture
def finals(tmp_path):
    """A finals2000A-format file of a few rows around the seeded epochs:
    rows with and without celestial-pole offsets, and lines that are not
    rows (a header, a blank, a truncated row), which ``_load`` skips."""
    rng = np.random.default_rng(7)
    lines = ["IERS finals2000A-format sample\n", "\n", "      48000.00 trunc\n"]
    for mjd in np.linspace(47800.0, 66500.0, 40):
        vals = (float(mjd), rng.uniform(-0.3, 0.3), rng.uniform(0.0, 0.6),
                rng.uniform(-0.9, 0.9))
        if rng.uniform() < 0.8:
            vals += (rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5))
        lines.append(_finals_line(*vals))
    path = tmp_path / "finals2000A.data"
    path.write_text("".join(lines))
    return str(path)


def test_epoch_conversions_are_jax_bitwise():
    for args in _epochs():
        te, je = frames.Epoch.from_gregorian_utc(*args), jframes.Epoch.from_gregorian_utc(*args)
        assert (te.jd1, te.jd2) == (je.jd1, je.jd2), args
        for name in ("to_jd_utc", "to_mjd_utc_days", "to_mjd_tt_days",
                     "to_tt_centuries_since_j2000", "to_tdb_centuries_since_j2000"):
            assert getattr(te, name)() == getattr(je, name)(), (name, args)
        t2, j2 = te + 4321.125, je + 4321.125
        assert (t2.jd1, t2.jd2) == (j2.jd1, j2.jd2)
    for ts in np.random.default_rng(1).uniform(631152000.0, 2240611200.0, 16):
        te, je = frames.Epoch.from_unix_seconds(ts), jframes.Epoch.from_unix_seconds(ts)
        assert (te.jd1, te.jd2) == (je.jd1, je.jd2)
    assert (frames.ARCSEC, frames.MJD_OFFSET, frames.TT_MINUS_UTC) == (
        jframes.ARCSEC, jframes.MJD_OFFSET, jframes.TT_MINUS_UTC)


def test_iers_load_matches_jax(finals):
    tiers, jiers = frames.IERS(finals), jframes.IERS(finals)
    assert len(tiers.mjd) == 40
    for name in ("mjd", "pm_x", "pm_y", "dut1", "dx", "dy"):
        np.testing.assert_array_equal(getattr(tiers, name), getattr(jiers, name), err_msg=name)
    assert (tiers.dx == 0.0).any() and (tiers.dx != 0.0).any()
    for mjd in np.random.default_rng(2).uniform(47000.0, 67000.0, 32):
        assert tiers.get_ut1_utc(mjd) == jiers.get_ut1_utc(mjd)
        assert tiers.get_pm(mjd) == jiers.get_pm(mjd)
        assert tiers.get_nutation(mjd) == jiers.get_nutation(mjd)


def test_iers_without_data_is_zero(tmp_path):
    for iers in (frames.IERS(None), frames.IERS(str(tmp_path / "missing.data"))):
        assert len(iers.mjd) == 0
        assert iers.get_ut1_utc(59000.0) == 0.0
        assert iers.get_pm(59000.0) == (0.0, 0.0)
        assert iers.get_nutation(59000.0) == (0.0, 0.0)


def test_iers_global_reads_the_environment(finals, monkeypatch):
    monkeypatch.setattr(frames.IERS, "_global", None)
    monkeypatch.setenv("ELODIN_IERS_PATH", finals)
    g = frames.IERS.global_()
    assert g is frames.IERS.global_()
    np.testing.assert_array_equal(g.dut1, jframes.IERS(finals).dut1)
    monkeypatch.setattr(frames.IERS, "_global", None)
    monkeypatch.delenv("ELODIN_IERS_PATH")
    assert len(frames.IERS.global_().mjd) == 0


@pytest.mark.parametrize("with_data", [False, True], ids=["no-iers", "iers"])
def test_eci_frames_are_jax_bitwise(with_data, finals):
    path = finals if with_data else None
    tiers, jiers = frames.IERS(path), jframes.IERS(path)
    for args in _epochs(3):
        te, je = frames.Epoch.from_gregorian_utc(*args), jframes.Epoch.from_gregorian_utc(*args)
        for name in ("bias_precession_nutation", "earth_rotation", "polar_motion",
                     "eci_to_ecef", "ecef_to_eci"):
            ours, ref = getattr(frames, name)(te, tiers), getattr(jframes, name)(je, jiers)
            assert isinstance(ours, np.ndarray) and ours.shape == (3, 3)
            np.testing.assert_array_equal(ours, ref, err_msg=f"{name} {args}")
        np.testing.assert_array_equal(frames.sun_vec(te), jframes.sun_vec(je))
        t = te.to_tt_centuries_since_j2000()
        assert frames.cio_xys(t) == jframes.cio_xys(t)
        assert frames._fundamental_args(t) == jframes._fundamental_args(t)
        jd = te.to_jd_utc()
        assert frames.earth_rotation_angle(jd) == jframes.earth_rotation_angle(jd)
        np.testing.assert_array_equal(frames.c2i_from_xys(*frames.cio_xys(t)),
                                      jframes.c2i_from_xys(*jframes.cio_xys(t)))
    for theta in np.random.default_rng(4).uniform(-7.0, 7.0, 16):
        for name in ("_rx", "_ry", "_rz"):
            np.testing.assert_array_equal(getattr(frames, name)(theta),
                                          getattr(jframes, name)(theta))
    np.testing.assert_array_equal(frames.c2i_from_xys(0.0, 0.0, 0.0),
                                  jframes.c2i_from_xys(0.0, 0.0, 0.0))


def test_eci_uses_the_global_iers_by_default(finals, monkeypatch):
    monkeypatch.setattr(frames.IERS, "_global", None)
    monkeypatch.setenv("ELODIN_IERS_PATH", finals)
    ep = frames.Epoch.from_gregorian_utc(2019, 1, 4, 12, 0, 0)
    np.testing.assert_array_equal(frames.eci_to_ecef(ep), frames.eci_to_ecef(ep, frames.IERS(finals)))
    monkeypatch.setattr(frames.IERS, "_global", None)


# -- the goldens of tests/test_frames_wmm.py, on the port --------------------------------


def test_earth_rotation_golden():
    ep = frames.Epoch.from_gregorian_utc(2019, 1, 4, 12, 0, 0)
    iers = frames.IERS(REF_IERS if os.path.isfile(REF_IERS) else None)
    er = frames.earth_rotation(ep, iers)
    expected = np.array(
        [[0.23457505, -0.97209801, 0.0], [0.97209801, 0.23457505, 0.0], [0.0, 0.0, 1.0]]
    )
    tol = 1e-5 if os.path.isfile(REF_IERS) else 1e-4
    np.testing.assert_allclose(er, expected, atol=tol)


def test_eci_to_ecef_golden():
    if not os.path.isfile(REF_IERS):
        pytest.skip("IERS data unavailable")
    ep = frames.Epoch.from_gregorian_utc(2019, 1, 4, 12, 0, 0)
    iers = frames.IERS(REF_IERS)
    x_eci = np.array([-2981784.0, 5207055.0, 3161595.0])
    x_ecef = frames.eci_to_ecef(ep, iers) @ x_eci
    expected = np.array([-5762648.74320628, -1682708.43849581, 3156027.93288401])
    assert np.abs(x_ecef - expected).max() < 1.0


def test_eci_ecef_roundtrip_orthonormal():
    ep = frames.Epoch.from_gregorian_utc(2022, 6, 15, 6, 30, 0)
    dcm = frames.eci_to_ecef(ep, frames.IERS(None))
    np.testing.assert_allclose(dcm @ dcm.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(dcm), 1.0, atol=1e-12)
    np.testing.assert_array_equal(frames.ecef_to_eci(ep, frames.IERS(None)), dcm.T)


def test_ned_to_ecef_golden():
    lat, long = np.radians(40.29959), np.radians(-111.72822)
    ecef = frames.ned_to_ecef(lat, long).numpy() @ np.array([4.0, 5.0, 6.0])
    np.testing.assert_allclose(ecef, [7.2966, 4.8032, -0.8300], atol=1e-4)


def test_sun_vec_golden():
    ep = frames.Epoch.from_gregorian_utc(2019, 1, 4, 12, 0, 0)
    sv = frames.sun_vec(ep)
    expected = np.array([0.23061245658276283, -0.8770198065823603, -0.3801863810692247])
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(sv, expected, atol=1e-2)


def test_sun_vec_equinox_and_solstice():
    sv = frames.sun_vec(frames.Epoch.from_gregorian_utc(2020, 3, 20, 3, 49, 0))
    assert np.degrees(np.arccos(np.clip(sv @ np.array([1.0, 0, 0]), -1, 1))) < 0.5
    eps = np.radians(23.4366)
    target = np.array([0.0, np.cos(eps), np.sin(eps)])
    sv = frames.sun_vec(frames.Epoch.from_gregorian_utc(2019, 6, 21, 15, 54, 0))
    assert np.degrees(np.arccos(np.clip(sv @ target, -1, 1))) < 0.5


def test_geodetic_roundtrip():
    lat = np.radians(np.array([-75.0, -10.0, 0.0, 33.0, 80.0]))
    lon = np.radians(np.array([10.0, 250.0, -45.0, 0.0, 179.0]))
    alt = np.array([0.0, 100.0, 5e3, 400e3, 35786e3])
    ecef = frames.geodetic_to_ecef(lat, lon, alt)
    lat2, lon2, alt2 = frames.ecef_to_geodetic(ecef)
    np.testing.assert_allclose(lat2.numpy(), lat, atol=1e-10)
    np.testing.assert_allclose(alt2.numpy(), alt, atol=1e-4)


def test_wmm_official_test_vector():
    # NOAA WMM2020 test value: 2020.0, h=0, lat=80N, lon=0
    b = wmm.field_ned(np.radians(80.0), 0.0, 0.0, 2020.0).numpy()
    np.testing.assert_allclose(b, [6570.4, -146.3, 54606.0], atol=0.5)


def test_wmm_equator_value():
    b = wmm.field_ned(0.0, np.radians(120.0), 0.0, 2020.0).numpy()
    np.testing.assert_allclose(b[0], 39624.3, atol=1.0)


def test_wmm_batched():
    lat = np.radians(np.array([80.0, 0.0, -80.0]))
    lon = np.radians(np.array([0.0, 120.0, 240.0]))
    alt = np.zeros(3)
    b = wmm.field_ned(lat, lon, alt, 2020.0).numpy()
    singles = np.stack([wmm.field_ned(la, lo, 0.0, 2020.0).numpy() for la, lo in zip(lat, lon)])
    np.testing.assert_allclose(b, singles, atol=1e-9)


def test_wmm_secular_variation():
    b0 = wmm.field_ned(np.radians(40.0), np.radians(-105.0), 0.0, 2020.0).numpy()
    b5 = wmm.field_ned(np.radians(40.0), np.radians(-105.0), 0.0, 2024.0).numpy()
    assert 1.0 < np.abs(b5 - b0).max() < 1000.0


# -- wmm against the JAX package ----------------------------------------------------------


def test_wmm_tables_equal_jax():
    for name in ("_G", "_H", "_DG", "_DH", "_SCHMIDT", "_WMM2020"):
        np.testing.assert_array_equal(getattr(wmm, name), getattr(jwmm, name), err_msg=name)
    assert (wmm.WMM_EPOCH, wmm.N_MAX, wmm._RE_GEOMAG) == (jwmm.WMM_EPOCH, jwmm.N_MAX,
                                                         jwmm._RE_GEOMAG)


def test_wmm_tables_move_to_a_device_once():
    x = torch.linspace(-1.0, 1.0, 5, dtype=torch.float64)
    first = wmm._tables(x.device)
    wmm.field_ned(x, x, 0.0)
    assert wmm._tables(x.device) is first
    np.testing.assert_array_equal(first.g.numpy(), wmm._G)


def _draws(seed, n=513):
    """Seeded (lat, long, alt, year): lat over the sphere with both poles
    exactly and within 1e-13 rad of them, alt from -1 km to GEO."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, n)
    lat[:6] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-13, -np.pi / 2 + 1e-13, 0.0, 1e-9]
    lon = rng.uniform(-np.pi, 2 * np.pi, n)
    alt = rng.uniform(-1e3, 3.6e7, n)
    alt[:8] = 0.0
    year = float(rng.uniform(2020.0, 2025.0))
    return lat, lon, alt, year


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wmm_matches_jax(seed):
    lat, lon, alt, year = _draws(seed)
    ours = wmm.field_ned(lat, lon, alt, year)
    assert ours.dtype == torch.float64 and ours.shape == (len(lat), 3)
    assert rel_err(ours, np.asarray(jwmm.field_ned(lat, lon, alt, year))) <= TOL
    # field_spherical on geocentric inputs, the poles' colatitudes exactly
    r = 6.3712e6 + alt
    theta = np.pi / 2 - lat
    theta[:2] = [0.0, np.pi]
    for o, j in zip(wmm.field_spherical(r, theta, lon, year),
                    jwmm.field_spherical(r, theta, lon, year)):
        assert rel_err(o, np.asarray(j)) <= TOL
    # degrees: each against the scale of its output
    for o, j in zip(wmm.declination_inclination(lat, lon, alt, year),
                    jwmm.declination_inclination(lat, lon, alt, year)):
        assert rel_err(o, np.asarray(j)) <= TOL


def test_wmm_legendre_matches_jax():
    x = np.concatenate([np.linspace(-1.0, 1.0, 101), [1.0 - 1e-15, -1.0 + 1e-15]])
    for o, j in zip(wmm._legendre_schmidt(torch.as_tensor(x), wmm.N_MAX),
                    jwmm._legendre_schmidt(jnp.asarray(x), jwmm.N_MAX)):
        assert rel_err(o, np.asarray(j)) <= TOL


def test_wmm_takes_the_device_of_a_tensor_argument():
    lat = torch.tensor([0.3, -0.4], dtype=torch.float32)
    b = wmm.field_ned(lat, 1.0, 0.0)
    assert b.dtype == torch.float64 and b.device == lat.device and b.shape == (2, 3)
    ref = wmm.field_ned(lat.double().numpy(), 1.0, 0.0)
    torch.testing.assert_close(b, ref, rtol=0, atol=0)
