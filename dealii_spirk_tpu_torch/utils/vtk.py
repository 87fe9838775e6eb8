"""ParaView output for tensor-product grids.

Port of ``dealii_spirk_tpu/utils/vtk.py`` (the reference's VTU/PVTU output,
``DataOut`` + ``write_vtu_with_pvtu_record``, reference ``main.cc:3417-3434``,
gated by ``DoOutputParaview``).  The tensor grid maps onto VTK's
RectilinearGrid (.vtr: per-axis coordinate vectors), with a .pvd collection
indexing the time series.  numpy code: for the same arrays it writes the
JAX package's files byte for byte.
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np
import torch


def _binary(a: np.ndarray) -> str:
    """VTK inline binary: base64 of the uint32 byte count and the raw
    little-endian f64 data."""
    raw = np.ascontiguousarray(a, dtype="<f8").tobytes()
    return base64.b64encode(struct.pack("<I", len(raw)) + raw).decode()


def write_vtr(
    path: str, coords: list[np.ndarray], values: np.ndarray, name: str = "U"
) -> None:
    """Write one rectilinear-grid file.

    ``coords``: per-axis node coordinates (including boundary nodes);
    ``values``: nodal tensor with shape ``tuple(len(c) for c in coords)``,
    axes ordered (x, y[, z]).
    """
    dims = [len(c) for c in coords]
    while len(dims) < 3:
        coords = coords + [np.zeros(1)]
        dims.append(1)
        values = values[..., None]
    ext = f"0 {dims[0] - 1} 0 {dims[1] - 1} 0 {dims[2] - 1}"
    flat = values.ravel(order="F")  # VTK point order: x fastest
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write(
            '<VTKFile type="RectilinearGrid" version="0.1" '
            'byte_order="LittleEndian">\n'
        )
        f.write(f'  <RectilinearGrid WholeExtent="{ext}">\n')
        f.write(f'    <Piece Extent="{ext}">\n')
        f.write(f'      <PointData Scalars="{name}">\n')
        f.write(
            f'        <DataArray type="Float64" Name="{name}" '
            f'format="binary">{_binary(flat)}</DataArray>\n'
        )
        f.write("      </PointData>\n")
        f.write("      <Coordinates>\n")
        for c in coords:
            f.write(
                '        <DataArray type="Float64" format="binary">'
                f"{_binary(c)}</DataArray>\n"
            )
        f.write("      </Coordinates>\n")
        f.write("    </Piece>\n")
        f.write("  </RectilinearGrid>\n")
        f.write("</VTKFile>\n")


class ParaviewSeries:
    """result_<step>.vtr files plus a result.pvd time collection."""

    def __init__(self, directory: str = ".", prefix: str = "result"):
        self.directory = directory
        self.prefix = prefix
        self.entries: list[tuple[float, str]] = []

    def write(self, u_interior, x_interior, time: float, step: int) -> None:
        """One step's file: ``u_interior`` the field on the interior nodes
        (a tensor on any device, or an array), ``x_interior`` their 1D
        coordinates."""
        if isinstance(u_interior, torch.Tensor):
            u_interior = u_interior.detach().to("cpu", torch.float64).numpy()
        u = np.asarray(u_interior, dtype=np.float64)
        # add the homogeneous-Dirichlet boundary nodes back
        u_full = np.pad(u, [(1, 1)] * u.ndim)
        coords = [
            np.concatenate([[0.0], np.asarray(x_interior), [1.0]])
        ] * u.ndim
        fname = f"{self.prefix}_{step:04d}.vtr"
        write_vtr(os.path.join(self.directory, fname), coords, u_full)
        self.entries.append((time, fname))
        self._write_pvd()

    def _write_pvd(self) -> None:
        path = os.path.join(self.directory, f"{self.prefix}.pvd")
        with open(path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write(
                '<VTKFile type="Collection" version="0.1" '
                'byte_order="LittleEndian">\n  <Collection>\n'
            )
            for t, fname in self.entries:
                f.write(
                    f'    <DataSet timestep="{t}" group="" part="0" '
                    f'file="{fname}"/>\n'
                )
            f.write("  </Collection>\n</VTKFile>\n")
