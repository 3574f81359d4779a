"""Analysis layer: model introspection and embeddings (the port of
``eyegaze_tpu/analysis``'s introspection and embedding modules; the error
analysis, comparison, learning curves and figures are not ported yet)."""

from eyegaze_tpu_torch.analysis.eeg_introspect import (
    BAND_NAMES,
    CHANNEL_POSITIONS_2D,
    FEATURE_NAMES,
    STANDARD_32_CHANNELS,
    extract_attention_maps,
    extract_embeddings,
    extract_ibs_matrices,
    frequency_sensitivity,
    gradcam_spectrogram,
    run_inference,
)
from eyegaze_tpu_torch.analysis.embedding import pca_embed, tsne_embed, umap_embed
from eyegaze_tpu_torch.analysis.gaze_introspect import (
    denormalize_image,
    extract_cls_features,
    input_saliency,
    vit_gradcam,
)
