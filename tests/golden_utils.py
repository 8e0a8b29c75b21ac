"""Golden-image test harness replicating the reference procedure
(integration_tests.rs:305-350): render, save actual, blur-downsample both to
100x50, RMS-similarity score must exceed 0.95.

Every comparison also PERSISTS its similarity score to
``tests/output/golden_scores.json`` so near-threshold goldens are visible
(a bare pass/fail hides a golden drifting from 0.99 toward 0.951)."""
import json
import os

import numpy as np
from PIL import Image

from solstrale import Renderer
from solstrale.utils import compare_images_rms

THRESHOLD = 0.95
EXPECTED_DIR = "/root/reference/tests/output"
ACTUAL_DIR = os.path.join(os.path.dirname(__file__), "output")
SCORES_PATH = os.path.join(ACTUAL_DIR, "golden_scores.json")


def render_and_compare(scene, name, expected_name=None, threshold=THRESHOLD):
    image = Renderer(scene).render_final()
    compare_output(image, name, expected_name, threshold)
    return image


def _record_score(name, score, threshold):
    """Append/overwrite this test's score in the persistent score file."""
    scores = {}
    if os.path.exists(SCORES_PATH):
        try:
            with open(SCORES_PATH) as f:
                scores = json.load(f)
        except (OSError, ValueError):
            scores = {}
    scores[name] = {"score": round(float(score), 4),
                    "threshold": threshold,
                    "margin": round(float(score) - threshold, 4)}
    with open(SCORES_PATH, "w") as f:
        json.dump(dict(sorted(scores.items())), f, indent=1)


def compare_output(actual_u8, name, expected_name=None, threshold=THRESHOLD):
    os.makedirs(ACTUAL_DIR, exist_ok=True)
    Image.fromarray(np.asarray(actual_u8)).save(
        os.path.join(ACTUAL_DIR, f"out_actual_{name}.jpg"))
    expected_path = os.path.join(
        EXPECTED_DIR, f"out_expected_{expected_name or name}.jpg")
    expected = np.asarray(Image.open(expected_path).convert("RGB"))
    score = compare_images_rms(np.asarray(actual_u8), expected)
    _record_score(name, score, threshold)
    assert score > threshold, f"Comparison score for {name} is: {score}"
