"""Host-side data: trial metadata and splits, sliding windows, batch loaders, synthetic
fixtures, ART's data and the CSV loader, and the image ops of the gaze pairs."""
