"""User-facing workflows; each module is also a CLI.

Imported lazily: an entry point pulls in the whole stack, so each is
reached through ``__getattr__`` rather than imported here.
"""

_ENTRYPOINTS = {
    "aggregate_images": "aggregate_images",
    "render_labels": "render_labels",
    "project_detections": "project_detections",
    "multiview_detections": "multiview_detections",
    "render_height_masks": "render_height_masks",
    "label_polygons": "label_polygons",
    "determine_minimum_overlapping_images": "annotation_image_selection",
    "chip_ortho": "chip_ortho",
    "assemble_ortho_predictions": "assemble_ortho_predictions",
    "visualize": "visualize",
}

__all__ = list(_ENTRYPOINTS)


def __getattr__(name):
    if name in _ENTRYPOINTS:
        import importlib

        mod = importlib.import_module(
            f"geograypher_tpu_torch.entrypoints.{_ENTRYPOINTS[name]}"
        )
        return getattr(mod, name)
    raise AttributeError(name)
