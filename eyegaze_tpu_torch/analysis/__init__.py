"""Analysis layer: model introspection, embeddings, error analysis,
comparison, learning curves and the MATLAB figure suites (the port of
``eyegaze_tpu/analysis``).  The numbers need neither pandas nor matplotlib;
the tables and figures import them at their first use."""

from eyegaze_tpu_torch.analysis.comparison import ModelResults, MultiModelComparator
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
from eyegaze_tpu_torch.analysis.error_analysis import ErrorAnalyzer, MechanismAnalyzer
from eyegaze_tpu_torch.analysis.gaze_introspect import (
    denormalize_image,
    extract_cls_features,
    input_saliency,
    vit_gradcam,
)
from eyegaze_tpu_torch.analysis.learning_curves import LearningCurveAnalyzer
from eyegaze_tpu_torch.analysis.matlab_parity import (
    render_all_suites,
    render_attention_suite,
    render_entropy_suite,
    render_frequency_sensitivity_bar,
    render_gradcam_suite,
    render_ibs_suite,
)
