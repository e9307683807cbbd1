"""datakit — columnar annotation-processing pipeline.

Re-designs the reference's row-at-a-time pandas/JSON pipeline
(reference: core/processor.py) as: one JSON parse per row into padded
fixed-shape arrays, then vectorized/jitted array ops for the numeric steps
(poly->bbox, pairwise-IoU filtering). Step functions keep the reference's
signatures and artifact contracts so the UI and saved configs work unchanged.
"""

from .steps import (  # noqa: F401
    merge_all_csv_in_folder,
    deduplicate_csv_by_source,
    remove_duplicates_between_csv,
    overwrite_reference_with_result,
    process_csv_replace_ptlist,
    filter_by_box_count_and_iou,
    replace_labels_by_mapping,
    split_dataset_by_rules,
    summarize_unclassified,
)
from .yolo_dataset import (  # noqa: F401
    generate_yolo_datasets_from_excels,
    summarize_yolo_label_counts,
)
from .visualize import download_and_draw_annotations  # noqa: F401
