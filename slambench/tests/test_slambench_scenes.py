"""The frozen scene generator (slambench/scenes/ring_orbit.py) equals the
port's generators (rover_slam_tpu_torch/utils/synthetic.py) at a small
size: the same world, frames, routes and IMU samples, to the bit."""
import numpy as np

from rover_slam_tpu_torch.utils import synthetic
from slambench.scenes import ring_orbit


def test_world_and_frames_equal_the_ports():
    kw = dict(n_sprites=300, patch=17, seed=4, image_hw=(96, 128), ring_orbit_radius=5.0)
    ours = ring_orbit.make_photo_world(**kw)
    port = synthetic.make_photo_world(layout="ring", **kw)
    for f in ("points", "patches", "cam_params", "z0"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(port, f))
    R, t, times = ring_orbit.orbit_trajectory(n_frames=12, orbit_radius=5.0, revs=0.2, dt=0.05)
    Rp, tp, timesp = synthetic.orbit_trajectory(n_frames=12, orbit_radius=5.0, revs=0.2, dt=0.05)
    for a, b in ((R, Rp), (t, tp), (times, timesp)):
        np.testing.assert_array_equal(a, b)
    for i in (0, 5, 11):
        np.testing.assert_array_equal(ring_orbit.render_photo_frame(ours, R[i], t[i]),
                                      synthetic.render_photo_frame(port, Rp[i], tp[i]))


def test_imu_orbit_equals_the_ports():
    kw = dict(n_frames=8, orbit_radius=5.0, revs=0.1, dt=1 / 30, hz=200, seed=11)
    ours = ring_orbit.orbit_with_imu(**kw)
    port = synthetic.orbit_with_imu(**kw)
    for a, b in zip(ours[:4], port[:4]):
        np.testing.assert_array_equal(a, b)
    assert len(ours[4]) == len(port[4]) == 7
    for (a1, g1, t1), (a2, g2, t2) in zip(ours[4], port[4]):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(t1, t2)


def test_seed_moves_the_start_not_the_route():
    """Every seed's scene is a stretch of one route, which does not depend
    on the seed: the same world and per-frame motion, from a start the seed
    draws among the first start_offsets frames."""
    traffic = {"world": {"n_sprites": 50, "patch": 17, "seed": 0, "ring_radius": 12.0,
                         "ring_height": 3.0, "ring_spread": 4.0, "orbit_radius": 5.0},
               "route": {"frames": 6, "orbit_radius": 5.0, "revolutions_per_frame": 0.006875},
               "start_offsets": 40}
    cfg = {"width": 64, "height": 48, "fx": 40.0, "fy": 40.0, "cx": 32.0, "cy": 24.0,
           "camera_hz": 30}
    route = ring_orbit.make_route(traffic, cfg)
    assert len(route.times) == 46
    np.testing.assert_array_equal(route.R_cw, ring_orbit.make_route(traffic, cfg).R_cw)
    starts = set()
    for seed in (1, 2, 3, 2 ** 31 + 5, 3 * 2 ** 32):
        sc = ring_orbit.for_seed(route, traffic, seed)
        assert ring_orbit.for_seed(route, traffic, seed).first == sc.first
        assert 0 <= sc.first < 40 and len(sc.times) == 6
        np.testing.assert_array_equal(sc.t_cw, route.t_cw[sc.first:sc.first + 6])
        np.testing.assert_array_equal(sc.render(2), route.render(sc.first + 2))
        starts.add(sc.first)
    assert len(starts) > 1
