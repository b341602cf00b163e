"""Command-line tools: render, bvh_builder, envmap_converter, bump2normal
and obj_tool, run as `python -m aten_tpu_torch.cli.<tool>`; the
counterparts of aten_tpu/cli."""
