"""Signal ops on tensors: preprocessing, spectra, connectivity."""
