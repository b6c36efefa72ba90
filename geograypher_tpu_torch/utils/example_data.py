"""Synthetic survey generator for end-to-end tests and examples.

Port of ``geograypher_tpu/utils/example_data.py``: a complete fake
Metashape export (a georeferenced scene mesh as PLY, a camera XML with a
chunk -> ECEF component transform, per-camera label images rendered by
the port's own ``render_flat``, ground-truth label polygons and a flat
DTM GeoTIFF, :func:`create_example_survey`); a 360-capture under-canopy
survey (:func:`create_undercanopy_survey`); and the concept figure's
scene (:func:`create_scene_mesh`, :func:`create_non_overlapping_points`),
so every entry point can run hermetically.  Seeded alike, each gives the
JAX package's mesh, labels and cameras.
"""

from __future__ import annotations

import textwrap
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from geograypher_tpu_torch.cameras.metashape import MetashapeCameraSet
from geograypher_tpu_torch.cameras.rig import create_rig_cameras_from_equirectangular
from geograypher_tpu_torch.meshes.mesh import TexturedMesh
from geograypher_tpu_torch.ops.rasterize import RasterConfig
from geograypher_tpu_torch.parallel.planner import census_caps
from geograypher_tpu_torch.utils import crs as crs_utils
from geograypher_tpu_torch.utils.fixtures import (
    _box_mesh,
    make_grid_mesh,
    make_scene_mesh,
    nadir_camera,
)
from geograypher_tpu_torch.utils.image import perspective_from_equirectangular
from geograypher_tpu_torch.utils.io import encode_png, write_image
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


UNDERCANOPY_RIG_ORIENTATIONS = [
    {"yaw_deg": 0.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 90.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 180.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 270.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 0.0, "pitch_deg": -90.0, "roll_deg": 0.0},
    {"yaw_deg": 0.0, "pitch_deg": 90.0, "roll_deg": 0.0},
]
UNDERCANOPY_FORMAT_STR = "_yaw{yaw_deg:03.0f}_pitch{pitch_deg:03.0f}"


def create_undercanopy_survey(
    output_folder,
    n_stations: int = 3,
    sensor: int = 128,
    scene_size: float = 20.0,
    n_objects: int = 4,
    station_height: float = 1.6,
    pano_size: tuple = (128, 256),
    lat: float = 36.0,
    lon: float = -119.0,
    seed: int = 0,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Write a synthetic under-canopy 360-capture survey to disk.

    Ground-level equirectangular captures between canopy objects (one
    synthetic panorama, a yaw hue by pitch brightness gradient, at every
    station), their perspective re-projections through the rig of
    :data:`UNDERCANOPY_RIG_ORIENTATIONS` (the "raw" image folder), and a
    parallel folder of per-pixel class predictions for those images: the
    known per-face labels rendered through the rig camera set on
    ``device`` (the card by default), occlusion-correct, so an aggregation
    can be checked against the truth exactly.  Images are written as the
    JAX package's cv2 writes them (decoded, the same pixels; the
    panorama's and views' channels are in cv2's order).  A station's
    panorama and its views are the same at every station, so they are
    resampled and encoded once.  The render's tile-list caps are sized by
    a census of the rig views, so no view overflows at any ``sensor`` (the
    JAX package's fixed (1024, 128, 64, 32) would at a camera's own
    resolution).  ``stats``,
    when given, gets the seconds of the resampling (``resample_s``, one
    entry a rig member), of the image writes (``write_s``) and of the
    label renders (``render_s``, the census included), and the ``caps``
    they ran at.

    Returns a dict of paths and ground truth: cameras_file, mesh_file,
    equirect_folder, perspective_folder, prediction_folder, rig_camera,
    rig_orientations, format_str, face_labels, n_classes, local_to_ecef.
    """
    stats = {} if stats is None else stats
    output_folder = Path(output_folder)
    equirect_folder = output_folder / "equirect"
    perspective_folder = output_folder / "images-reprojected"
    prediction_folder = output_folder / "predictions"
    for f in (equirect_folder, perspective_folder, prediction_folder):
        f.mkdir(parents=True, exist_ok=True)

    verts, faces, face_labels, centers = make_scene_mesh(
        n_objects=n_objects, ground_n=21, size=scene_size, seed=seed
    )
    l2e = local_to_ecef_frame(lat, lon)

    # ground-level stations on a walking line through the scene, nudged
    # off any canopy object's footprint (beside the objects, not inside)
    xs = np.linspace(-scene_size / 4, scene_size / 4, n_stations)
    stations = []
    for x in xs:
        pos = np.array([x, 0.0, station_height])
        for _ in range(20):
            clear = all(
                max(abs(pos[0] - cx_), abs(pos[1] - cy_)) > half + 0.7
                for cx_, cy_, _h, half in centers
            )
            if clear:
                break
            pos[1] += 0.9
        stations.append(pos.copy())

    # the 360 camera: upright, looking east; camera x right, y down, z
    # forward, so x_cam = -north, y_cam = -up, z_cam = east
    base_rot = np.eye(4)
    base_rot[:3, 0] = [0.0, -1.0, 0.0]
    base_rot[:3, 1] = [0.0, 0.0, -1.0]
    base_rot[:3, 2] = [1.0, 0.0, 0.0]
    c2ws, names = [], []
    for k, pos in enumerate(stations):
        c2w = base_rot.copy()
        c2w[:3, 3] = pos
        c2ws.append(c2w)
        names.append(f"pano_{k:04d}.png")

    cameras_file = output_folder / "cameras.xml"
    # Metashape labels are absolute paths of the photogrammetry-time images
    cameras_file.write_text(
        make_metashape_xml(
            c2ws, [str(equirect_folder / n) for n in names], l2e,
            sensor / 2.0, sensor, sensor,
        )
    )
    mesh_file = output_folder / "mesh.ply"
    save_mesh(mesh_file, verts, faces)

    he, we = pano_size
    yy, xx = np.mgrid[0:he, 0:we]
    pano = np.stack(
        [
            (255 * xx / we).astype(np.uint8),
            (255 * yy / he).astype(np.uint8),
            np.full((he, we), 96, np.uint8),
        ],
        axis=-1,
    )
    resample_s, views = [], []
    for o in UNDERCANOPY_RIG_ORIENTATIONS:
        t0 = time.perf_counter()
        views.append(perspective_from_equirectangular(
            pano, o["roll_deg"], o["pitch_deg"], o["yaw_deg"],
            fov_deg=90.0, out_size=(sensor, sensor),
        ))
        resample_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    # cv2 writes the arrays it is given as BGR: reverse the channels
    pano_png = encode_png(pano[..., ::-1])
    view_pngs = [encode_png(v[..., ::-1]) for v in views]
    for k in range(n_stations):
        (equirect_folder / names[k]).write_bytes(pano_png)
        for o, png in zip(UNDERCANOPY_RIG_ORIENTATIONS, view_pngs):
            out_name = Path(names[k]).stem + UNDERCANOPY_FORMAT_STR.format(**o) + ".png"
            (perspective_folder / out_name).write_bytes(png)
    write_s = time.perf_counter() - t0

    rig_camera = {
        "f": sensor / 2.0,  # a 90-degree horizontal field of view
        "cx": 0.0,
        "cy": 0.0,
        "image_width": sensor,
        "image_height": sensor,
    }
    # occlusion-correct per-pixel "predictions" of every perspective image
    rig_set = create_rig_cameras_from_equirectangular(
        camera_file=cameras_file,
        original_images=equirect_folder,
        perspective_images=perspective_folder,
        rig_camera=rig_camera,
        rig_orientations=UNDERCANOPY_RIG_ORIENTATIONS,
        perspective_filename_format_str=UNDERCANOPY_FORMAT_STR,
    )
    t0 = time.perf_counter()
    mesh = TexturedMesh(mesh_file, transform_filename=cameras_file, device=device)
    mesh.raster_config = census_caps(mesh.view_raster_census(rig_set),
                                     mesh.raster_config)
    mesh.set_texture(face_labels.astype(float), is_vertex=False)
    for cam_idx, img in enumerate(mesh.render_flat(rig_set)):
        lab = np.where(np.isfinite(img[..., 0]), img[..., 0], 255)
        write_image(prediction_folder / rig_set.image_filenames[cam_idx].name,
                    lab.astype(np.uint8))
    stats.update(resample_s=resample_s, write_s=write_s,
                 render_s=time.perf_counter() - t0, caps=tuple(mesh.raster_config.caps))

    return {
        "cameras_file": cameras_file,
        "mesh_file": mesh_file,
        "equirect_folder": equirect_folder,
        "perspective_folder": perspective_folder,
        "prediction_folder": prediction_folder,
        "rig_camera": rig_camera,
        "rig_orientations": list(UNDERCANOPY_RIG_ORIENTATIONS),
        "format_str": UNDERCANOPY_FORMAT_STR,
        "face_labels": face_labels,
        "n_classes": int(face_labels.max()) + 1,
        "local_to_ecef": l2e,
    }


def create_non_overlapping_points(
    n_points: int,
    distance_thresh: float = 1.0,
    size: float = 10.0,
    random_seed: Optional[int] = None,
) -> np.ndarray:
    """``n_points`` 2D points more than ``distance_thresh`` apart inside a
    ``size`` x ``size`` square centred on the origin, by rejection
    sampling from ``random_seed``."""
    rng = np.random.default_rng(random_seed)
    points = (rng.random((1, 2)) - 0.5) * size
    while points.shape[0] < n_points:
        cand = (rng.random((1, 2)) - 0.5) * size
        if np.min(np.linalg.norm(points - cand, axis=1)) > distance_thresh:
            points = np.concatenate([points, cand], axis=0)
    return points


def _cylinder_mesh(center, radius: float, height: float, resolution: int = 10):
    """Closed triangulated cylinder (axis +z, base at z=0)."""
    cx, cy = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    ring = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], 1)
    bot = np.concatenate([ring, np.zeros((resolution, 1))], axis=1)
    top = np.concatenate([ring, np.full((resolution, 1), height)], axis=1)
    verts = np.concatenate([bot, top, [[cx, cy, 0.0]], [[cx, cy, height]]], axis=0)
    cb, ct = 2 * resolution, 2 * resolution + 1
    faces = []
    for i in range(resolution):
        j = (i + 1) % resolution
        faces += [
            (i, j, resolution + i),  # side quad
            (j, resolution + j, resolution + i),
            (cb, j, i),  # bottom cap
            (ct, resolution + i, resolution + j),  # top cap
        ]
    return verts, np.array(faces, dtype=np.int32)


def _cone_mesh(center, radius: float, height: float, resolution: int = 12):
    """Closed triangulated cone (base at z=0, apex at z=height)."""
    cx, cy = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    ring = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], 1)
    base = np.concatenate([ring, np.zeros((resolution, 1))], axis=1)
    verts = np.concatenate([base, [[cx, cy, 0.0]], [[cx, cy, height]]], axis=0)
    cb, apex = resolution, resolution + 1
    faces = []
    for i in range(resolution):
        j = (i + 1) % resolution
        faces += [(i, j, apex), (cb, j, i)]
    return verts, np.array(faces, dtype=np.int32)


def create_scene_mesh(
    box_centers=(),
    cylinder_centers=(),
    cone_centers=(),
    cylinder_radius: float = 0.5,
    cone_radius: float = 0.5,
    box_size: float = 1.0 / np.sqrt(2.0),
    grid_size=(20.0, 20.0),
    add_ground: bool = True,
    ground_resolution: int = 200,
):
    """The concept figure's scene: boxes, cylinders and cones on an
    optional ground plane.

    Returns ``(verts, faces, face_IDs, labels_vd)``: ``face_IDs`` is a
    float per-face instance id (NaN on the ground, instances numbered over
    all shapes in box, cylinder, cone order), and ``labels_vd`` a
    :class:`~geograypher_tpu_torch.utils.vector.VectorData` of each
    instance's convex-hull footprint with a ``name`` column in {"cube",
    "cylinder", "cone"}.
    """
    from scipy.spatial import ConvexHull

    all_verts, all_faces, all_ids = [], [], []
    polygons, names = [], []
    v_off = 0
    instance = 0.0

    def add(verts, faces, name):
        nonlocal v_off, instance
        all_verts.append(verts)
        all_faces.append(faces + v_off)
        all_ids.append(np.full((faces.shape[0],), instance))
        hull = ConvexHull(verts[:, :2])
        polygons.append(Polygon(verts[hull.vertices, :2]))
        names.append(name)
        v_off += verts.shape[0]
        instance += 1.0

    for x, y in box_centers:
        bv, bf = _box_mesh((x, y, 0.0), box_size / 2.0, box_size)
        add(bv, bf, "cube")
    for x, y in cylinder_centers:
        cv, cf = _cylinder_mesh((x, y), cylinder_radius, 1.0)
        add(cv, cf, "cylinder")
    for x, y in cone_centers:
        cv, cf = _cone_mesh((x, y), cone_radius, 1.0)
        add(cv, cf, "cone")

    if add_ground:
        gx, _gy = grid_size
        gv, gf = make_grid_mesh(n=int(ground_resolution), size=float(gx))
        all_verts.append(gv)
        all_faces.append(gf + v_off)
        all_ids.append(np.full((gf.shape[0],), np.nan))

    verts = np.concatenate(all_verts, axis=0)
    faces = np.concatenate(all_faces, axis=0).astype(np.int32)
    face_ids = np.concatenate(all_ids, axis=0)
    return verts, faces, face_ids, VectorData(polygons, {"name": names})
