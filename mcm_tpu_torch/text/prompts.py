"""Prompt templates for concept matching.

The eval path uses the single template ``"a photo of a {c}"``
(reference ``utils/detection_util.py:228``).  The 80 OpenAI ImageNet
templates and two curated subsets (reference ``utils/imagenet_templates.py``,
unused by its eval path but shipped as research capability) are available
for template ensembling: encode every (template × class) prompt, L2-normalize,
then average per class and re-normalize — the standard CLIP ensembling recipe.
"""

from __future__ import annotations

from typing import List, Sequence

DEFAULT_TEMPLATE = "a photo of a {}"

#: The 80 OpenAI CLIP ImageNet prompt templates (public prompt set).
OPENAI_IMAGENET_TEMPLATES: List[str] = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.",
    "the embroidered {}.", "a photo of a hard to see {}.",
    "a bright photo of a {}.", "a photo of a clean {}.",
    "a photo of a dirty {}.", "a dark photo of the {}.",
    "a drawing of a {}.", "a photo of my {}.", "the plastic {}.",
    "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.",
    "a photo of the dirty {}.", "a jpeg corrupted photo of a {}.",
    "a blurry photo of the {}.", "a photo of the {}.",
    "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.",
    "the origami {}.", "the {} in a video game.", "a sketch of a {}.",
    "a doodle of the {}.", "a origami {}.",
    "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.",
    "a photo of a nice {}.", "a photo of a weird {}.",
    "a blurry photo of a {}.", "a cartoon {}.", "art of a {}.",
    "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.",
    "a photo of the small {}.", "a photo of the weird {}.",
    "the cartoon {}.", "art of the {}.", "a drawing of the {}.",
    "a photo of the large {}.", "a black and white photo of a {}.",
    "the plushie {}.", "a dark photo of a {}.", "itap of a {}.",
    "graffiti of the {}.", "a toy {}.", "itap of my {}.",
    "a photo of a cool {}.", "a photo of a small {}.", "a tattoo of the {}.",
]

#: The reference's two hand-picked subsets, string-exact
#: (``imagenet_templates.py:85-102``, ``openai_imagenet_template_subset``).
CURATED_TEMPLATE_SUBSETS: dict = {
    0: [
        "a photo of a {}.", "a blurry photo of a {}.",
        "a photo of many {}.", "a photo of the large {}.",
        "a photo of the small {}.",
    ],
    1: [
        "itap of my {}.", "a bad photo of a {}.", "a origami {}.",
        "a photo of the large {}.", "a {} in a video game.",
        "art of the {}.", "a photo of the small {}.",
    ],
}

#: Back-compat alias for the 7-template subset (= subset 1 above).
SIMPLE_IMAGENET_TEMPLATES: List[str] = CURATED_TEMPLATE_SUBSETS[1]

PHOTO_TEMPLATES: List[str] = [DEFAULT_TEMPLATE]


def build_prompts(class_names: Sequence[str],
                  templates: Sequence[str] = (DEFAULT_TEMPLATE,)
                  ) -> List[str]:
    """[templates × classes] prompt strings, template-major ordering."""
    return [t.format(c) for t in templates for c in class_names]
