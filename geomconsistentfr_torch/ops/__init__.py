"""Camera geometry, shading and shadow-march ops of the PyTorch port."""
