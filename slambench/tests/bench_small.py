"""A cell of BENCHMARK.json cut to a size the CPU tests can run: 320x240
frames, 256 features, smaller RANSAC and BA capacities, a short prefix of
its traffic mix."""

from slambench import cell as cells

CAMERA = {"width": 320, "height": 240, "fx": 280.0, "fy": 280.0,
          "cx": 159.5, "cy": 119.5}
VO = {"map_capacity": 512, "ransac_hypotheses": 128, "pnp_hypotheses": 64,
      "ba_old": 192, "ba_new": 64}


def small_cell(workload: str, frames: int = 200):
    c = cells.resolve(workload)
    config = dict(c.config, camera=CAMERA, vo=VO,
                  orb=dict(c.config["orb"], max_features=256))
    traffic = c.traffic._replace(ts=c.traffic.ts[:frames],
                                 yaws=c.traffic.yaws[:frames],
                                 warmup_frames=4, profile_start=6,
                                 profile_frames=2)
    return c._replace(config=config, camera=cells.camera_of(config),
                      traffic=traffic)
