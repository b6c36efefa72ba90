"""Synthetic survey generator for end-to-end tests and examples.

Port of ``local_to_ecef_frame``, ``make_metashape_xml`` and
``create_example_survey`` of ``geograypher_tpu/utils/example_data.py``:
a complete fake Metashape export (a georeferenced scene mesh as PLY, a
camera XML with a chunk -> ECEF component transform, per-camera label
images rendered by the port's own ``render_flat``, and ground-truth label
polygons, and a flat DTM GeoTIFF), so every entry point can run
hermetically.
"""

from __future__ import annotations

import textwrap
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.fixtures import make_scene_mesh, nadir_camera
from geograypher_tpu_torch.utils.io import write_image
from geograypher_tpu_torch.utils.meshio import save_mesh
from geograypher_tpu_torch.utils.raster import Raster, write_geotiff
from geograypher_tpu_torch.utils.vector import Polygon, VectorData


def local_to_ecef_frame(lat: float, lon: float, alt: float = 0.0) -> np.ndarray:
    """4x4 local ENU frame -> ECEF at the given origin."""
    x, y, z = crs_utils.lla_to_ecef(lat, lon, alt)
    origin = np.array([float(x), float(y), float(z)])
    up = origin / np.linalg.norm(origin)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2] = east, north, up
    t[:3, 3] = origin
    return t


def make_metashape_xml(
    cam_to_worlds,
    image_names,
    local_to_ecef: np.ndarray,
    f: float,
    width: int,
    height: int,
    cx: float = 0.0,
    cy: float = 0.0,
    distortion: Optional[dict] = None,
    sensors: Optional[Sequence[dict]] = None,
    sensor_ids: Optional[Sequence[int]] = None,
) -> str:
    """Serialize cameras into the Metashape XML schema the parser reads.

    One sensor (``f``, ``cx``, ``cy``, ``distortion``) serves every
    camera, as in the JAX package; ``sensors`` (dicts with ``f`` and
    optionally ``cx``, ``cy``, ``distortion``, all of ``width`` x
    ``height``) and ``sensor_ids`` (one index into it per camera) write a
    survey flown with several lenses instead.
    """
    if sensors is None:
        sensors = [{"f": f, "cx": cx, "cy": cy, "distortion": distortion}]
    if sensor_ids is None:
        sensor_ids = [0] * len(image_names)
    sensor_tags = "\n".join(
        f'''<sensor id="{k}" label="synthetic" type="frame">
                <resolution width="{width}" height="{height}"/>
                <calibration type="frame" class="adjusted">
                  <resolution width="{width}" height="{height}"/>
                  <f>{s["f"]}</f>
                  <cx>{s.get("cx", 0.0)}</cx>
                  <cy>{s.get("cy", 0.0)}</cy>
                  {"".join(f"<{n}>{v}</{n}>" for n, v in (s.get("distortion") or {}).items())}
                </calibration>
              </sensor>'''
        for k, s in enumerate(sensors)
    )
    cams = "\n".join(
        f'<camera id="{i}" sensor_id="{sid}" label="{name}">'
        f'<transform>{" ".join(f"{float(v):.17g}" for v in np.asarray(t).flatten())}'
        f"</transform></camera>"
        for i, (t, name, sid) in enumerate(zip(cam_to_worlds, image_names, sensor_ids))
    )
    rot = " ".join(f"{float(v):.17g}" for v in local_to_ecef[:3, :3].flatten())
    tra = " ".join(f"{float(v):.17g}" for v in local_to_ecef[:3, 3])
    return textwrap.dedent(
        f"""\
        <document version="2.0.0">
          <chunk label="Chunk 1" enabled="true">
            <sensors next_id="{len(sensors)}">
              {sensor_tags}
            </sensors>
            <cameras next_id="{len(image_names)}" next_group_id="0">
              {cams}
            </cameras>
            <components next_id="1" active_id="0">
              <component id="0" label="Component 1">
                <transform>
                  <rotation locked="true">{rot}</rotation>
                  <translation locked="true">{tra}</translation>
                  <scale locked="true">1.0</scale>
                </transform>
              </component>
            </components>
          </chunk>
        </document>"""
    )


def create_example_survey(
    output_folder,
    n_cameras: int = 4,
    sensor: int = 96,
    focal: float = 48.0,
    scene_size: float = 40.0,
    n_objects: int = 3,
    lat: float = 36.0,
    lon: float = -119.0,
    seed: int = 0,
    write_label_images: bool = True,
    device="cuda",
):
    """Write a full synthetic survey to disk; the label images are
    rendered on ``device`` (the card by default).

    Returns a dict of paths + ground-truth arrays:
    mesh_file, cameras_file, image_folder, label_folder, face_labels,
    labels_vector_file, dtm_file, local_to_ecef, n_classes, utm_epsg.
    """
    output_folder = Path(output_folder)
    (output_folder / "images").mkdir(parents=True, exist_ok=True)
    (output_folder / "labels").mkdir(parents=True, exist_ok=True)

    verts, faces, face_labels, centers = make_scene_mesh(
        n_objects=n_objects, ground_n=21, size=scene_size, seed=seed
    )
    l2e = local_to_ecef_frame(lat, lon)

    # cameras: nadir grid pass over the scene
    cam_to_worlds = []
    names = []
    for k in range(n_cameras):
        c2w = nadir_camera(scene_size, focal, sensor)
        c2w[0, 3] = (k % 2) * scene_size * 0.2 - scene_size * 0.1
        c2w[1, 3] = (k // 2) * scene_size * 0.2 - scene_size * 0.1
        cam_to_worlds.append(c2w)
        names.append(f"img_{k:04d}.png")

    xml = make_metashape_xml(
        cam_to_worlds, names, l2e, focal, sensor, sensor
    )
    cameras_file = output_folder / "cameras.xml"
    cameras_file.write_text(xml)

    # The PLY is saved in the LOCAL chunk frame, exactly like a Metashape
    # mesh export: consumers apply the camera XML's component transform
    # (local -> ECEF) when loading.
    mesh_file = output_folder / "mesh.ply"
    save_mesh(mesh_file, verts, faces)

    # per-camera label images: render ground-truth labels with the engine
    if write_label_images:
        hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
        verts_ecef = (l2e @ hom.T).T[:, :3]
        cams = MetashapeCameraSet(cameras_file, output_folder / "images")
        mesh = TexturedMesh(
            (verts_ecef, faces),
            CRS=4978,
            raster_config=RasterConfig(caps=(512, 64, 32, 16)),
            local_to_epsg_4978_transform=l2e,
            device=device,
        )
        mesh.set_texture(face_labels.astype(float), is_vertex=False)
        for i, img in enumerate(mesh.render_flat(cams)):
            lab = np.where(np.isfinite(img[..., 0]), img[..., 0], 255)
            write_image(output_folder / "labels" / f"img_{i:04d}.png",
                        lab.astype(np.uint8))
            write_image(output_folder / "images" / f"img_{i:04d}.png",
                        np.full((sensor, sensor, 3), 127, np.uint8))

    # ground-truth object polygons in UTM
    utm = crs_utils.utm_epsg_for(lat, lon)
    origin_utm = crs_utils.transform_points(
        np.array([[lat, lon, 0.0]]), 4326, utm
    )[0]
    polys, labels = [], []
    for k, (cx_, cy_, h, half) in enumerate(centers):
        polys.append(
            Polygon(
                np.array(
                    [
                        [origin_utm[0] + cx_ - half, origin_utm[1] + cy_ - half],
                        [origin_utm[0] + cx_ + half, origin_utm[1] + cy_ - half],
                        [origin_utm[0] + cx_ + half, origin_utm[1] + cy_ + half],
                        [origin_utm[0] + cx_ - half, origin_utm[1] + cy_ + half],
                    ]
                )
            )
        )
        labels.append(f"object_{k + 1}")
    labels_vector_file = output_folder / "labels.geojson"
    VectorData(polys, {"species": labels}, epsg=utm).to_file(labels_vector_file)

    # flat DTM at ~0 elevation over the site
    dtm_file = output_folder / "dtm.tif"
    write_geotiff(
        dtm_file,
        Raster(
            data=np.zeros((64, 64), np.float32),
            transform=(
                2 * scene_size / 64, 0.0, origin_utm[0] - scene_size,
                0.0, -2 * scene_size / 64, origin_utm[1] + scene_size,
            ),
            epsg=utm,
        ),
    )

    return {
        "mesh_file": mesh_file,
        "cameras_file": cameras_file,
        "image_folder": output_folder / "images",
        "label_folder": output_folder / "labels",
        "labels_vector_file": labels_vector_file,
        "dtm_file": dtm_file,
        "face_labels": face_labels,
        "local_to_ecef": l2e,
        "n_classes": n_objects + 1,
        "utm_epsg": utm,
    }
