"""The example apps on the port — the PyTorch counterparts of
examples/*.py, each a module with run(...) (what it made: frames as
arrays, paths written, losses, the overflow counters) and main():

    python -m gsjax_torch.examples.simple_viewer [scene]          # an 8-frame orbit
    python -m gsjax_torch.examples.file_loader [scene]            # .splat/.qply/.ply → frame, .splat
    python -m gsjax_torch.examples.ply_converter [scene.ply]      # .ply → .splat
    python -m gsjax_torch.examples.scene_transformations [scene]  # rotate, translate, scale, box
    python -m gsjax_torch.examples.camera_updates [scene]         # camera JSON round trip
    python -m gsjax_torch.examples.train_fit                      # fit a perturbed scene back
    python -m gsjax_torch.examples.sharded_render                 # 8 bands: render, one step

Each runs on the card unless given --device cpu (there is no fallback),
writes under --out (default gsjax_torch/examples/out/), sizes its
budgets over its own renders (_common.sized_config: nothing dropped)
and prints, last, the largest of each overflow counter over its renders
and steps. run's keyword arguments hold the reference example's sizes,
so the same code runs small."""
