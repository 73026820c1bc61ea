"""The plain float32 reference of the cells' models and steps: PyTorch and
NumPy only, nothing of the program. ``model`` is the architecture,
``geometry`` the camera conditioning, ``sampling`` a whole 2-view request,
``training`` the epi fine-tuning steps, ``data`` the RealEstate10K reader."""
