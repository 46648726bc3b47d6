"""Two output files compared dataset by dataset, bit for bit.

What ``cli.simulate_pixels`` promises for any ``n_devices``: the same
groups and datasets in the same order, each with the same dtype, shape,
chunking, filters and attributes, and the same bits field by field.  The
padding bytes between the fields of a structured row are not compared:
numpy leaves them unset when it copies such arrays, so they differ from
run to run whatever the run does.
"""
from __future__ import annotations

import numpy as np

from ..io.h5 import File, Group


def datasets(g, prefix: str = '') -> dict:
    """name -> member, every group (its name ending in '/') and dataset
    under the group ``g``, in the file's order."""
    out = {}
    for name, obj in g.members.items():
        if isinstance(obj, Group):
            out[prefix + name + '/'] = obj
            out.update(datasets(obj, prefix + name + '/'))
        else:
            out[prefix + name] = obj
    return out


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal dtype, shape and bits, field by field."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.names is None:
        return np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes()
    return all(bits_equal(a[n], b[n]) for n in a.dtype.names)


def _attrs_equal(a, b) -> bool:
    a, b = dict(a), dict(b)
    return sorted(a) == sorted(b) and all(bits_equal(a[k], b[k]) for k in a)


def differences(path_a: str, path_b: str) -> list[str]:
    """What differs between two files (empty when every dataset is the
    same, bit for bit)."""
    out = []
    with File(path_a, 'r') as fa, File(path_b, 'r') as fb:
        if not _attrs_equal(fa.attrs, fb.attrs):
            out.append('/: attributes')
        ma, mb = datasets(fa), datasets(fb)
        if list(ma) != list(mb):
            out.append(f'members {list(ma)} vs {list(mb)}')
        for name in ma.keys() & mb.keys():
            a, b = ma[name], mb[name]
            if not _attrs_equal(a.attrs, b.attrs):
                out.append(f'{name}: attributes')
            if name.endswith('/'):
                continue
            for key in ('chunks', 'maxshape', 'compression'):
                if getattr(a, key, None) != getattr(b, key, None):
                    out.append(f'{name}: {key}')
            if not bits_equal(np.asarray(a), np.asarray(b)):
                out.append(f'{name}: data')
    return sorted(out)
