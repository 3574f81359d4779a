"""Host-side data: trial metadata and splits, sliding windows, batch loaders, synthetic fixtures."""
