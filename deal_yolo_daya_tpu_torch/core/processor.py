"""Compat facade: the reference's processor API (core/processor.py:26-1163)
re-exported from the columnar datakit implementation."""

from ..datakit.steps import (  # noqa: F401
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
from ..datakit.yolo_dataset import (  # noqa: F401
    generate_yolo_datasets_from_excels,
    summarize_yolo_label_counts,
)
from ..datakit.visualize import download_and_draw_annotations  # noqa: F401
