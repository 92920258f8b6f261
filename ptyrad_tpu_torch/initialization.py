"""Host-side measurement preparation (a narrow part of the Initializer).

Counterpart of the ``on_the_fly`` branches of
ptyrad_tpu/initialization.py:Initializer._meas_pad (:314-373) and
._meas_resample (:375-406). The rest of the Initializer (loading, cropping,
calibration, probe/object/position initialisation) waits for ROADMAP queue A.
"""

from __future__ import annotations

import numpy as np

from ptyrad_tpu_torch.ops.resize import out_size
from ptyrad_tpu_torch.utils.image_proc import (create_one_hot_mask, exponential_decay,
                                               fit_background, power_law)

PADDING_TYPES = ("constant", "edge", "linear_ramp", "exp", "power")


def meas_pad_on_the_fly(meas: np.ndarray, padding_type: str, target_npix: int,
                        threshold: float = 70, value: float = 10):
    """The background canvas for padding (N, h, w) patterns to
    target_npix^2 on the device, batch by batch.

    Returns (meas_padded (Kp, Kp) float32, [h1, h2, w1, w2]): the squared
    padded mean amplitude with the measured window [h1:h2, w1:w2] zeroed,
    and that window. ``make_model`` takes them as on_the_fly_meas_padded and
    on_the_fly_meas_padded_idx; ``get_measurements`` writes each batch into
    the window. padding_type: constant / edge / linear_ramp (with
    ``value``), or exp / power (a radial decay fitted to the dimmest
    ``threshold`` % of the mean amplitude).
    """
    if padding_type not in PADDING_TYPES:
        raise ValueError(f"Unsupported padding_type '{padding_type}'; use one of "
                         f"{sorted(PADDING_TYPES)}")
    amp_avg = np.sqrt(np.asarray(meas).mean(axis=0))
    h, w = amp_avg.shape
    pad_y, pad_x = max(0, target_npix - h), max(0, target_npix - w)
    py1, py2 = pad_y // 2, pad_y - pad_y // 2
    px1, px2 = pad_x // 2, pad_x - pad_x // 2
    h1, h2, w1, w2 = py1, py1 + h, px1, px1 + w
    pads = ((py1, py2), (px1, px2))

    if padding_type == "constant":
        amp_padded = np.pad(amp_avg, pads, mode="constant", constant_values=value)
    elif padding_type == "edge":
        amp_padded = np.pad(amp_avg, pads, mode="edge")
    elif padding_type == "linear_ramp":
        amp_padded = np.pad(amp_avg, pads, mode="linear_ramp", end_values=value)
    else:
        y, x = np.ogrid[:target_npix, :target_npix]
        cy, cx = h // 2 + py1, w // 2 + px1
        r = np.sqrt((y - cy) ** 2 + (x - cx) ** 2) + 1e-10
        model = exponential_decay if padding_type == "exp" else power_law
        mask = create_one_hot_mask(amp_avg, percentile=threshold)
        amp_padded = model(r, *fit_background(amp_avg, mask, padding_type))

    meas_padded = np.square(amp_padded).astype("float32")
    meas_padded[h1:h2, w1:w2] = 0
    return meas_padded, [h1, h2, w1, w2]


def meas_resample_on_the_fly(meas: np.ndarray, scale_factors, meas_padded=None):
    """The scale factors for resampling (N, h, w) patterns on the device,
    batch by batch, and the pattern size that results.

    Returns ([s, s], npix): the two factors equalised to the smaller one, and
    floor(base * s), where the base size is the padded template's when an
    on-the-fly pad is active (``meas_padded`` from meas_pad_on_the_fly; the
    stored array stays unpadded) and the data's otherwise. ``make_model``
    takes the factors as on_the_fly_meas_scale_factors; ``get_measurements``
    pads, then resamples each batch; the probe must be npix wide.
    """
    scale = [float(s) for s in scale_factors]
    if len(scale) != 2:
        raise ValueError("scale_factors must have two entries")
    if scale[0] != scale[1]:
        scale = [min(scale)] * 2
    base = np.shape(meas_padded)[-1] if meas_padded is not None else np.shape(meas)[-1]
    return scale, out_size(int(base), scale[-1])
