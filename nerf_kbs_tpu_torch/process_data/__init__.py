"""The preprocessing pipeline (the JAX package's ``process_data/``), inference
only: motion masks from monodepth2 depth and pose, RAFT flow and the
instance segmenter (``motion_mask_driver``), flow extraction
(``raft_driver``), video inpainting (``inpaint``), and COLMAP models to
``transforms.json`` and ``metadata.json`` (``colmap_io``,
``create_transform``, ``metadata``). The networks are in ``networks/``;
``convert`` carries the JAX package's flax variables across.

The drivers run on the CUDA card unless the caller passes ``device="cpu"``.
No module imports PIL or OpenCV: frames are read and written with
``utils.images`` and ``utils.jpeg``."""
