"""Material cross-section tables (host-side numpy).

The port's own copy of the JAX package's ``physics/materials.py``: the
``.mcgpu`` interchange-file parser (MC-GPU v1.3's material format, plain or
gzipped), the packed ``.npz`` reader and writer, the density-ordered table
set and the two linearisations the engine tables are built from.
PENELOPE-2006-derived per-material photon data: mean free paths on a
uniform energy grid, RITA tables of the squared molecular form factor, and
Compton shell data.

Material *numbers* are 1-based in geometry arrays; the engine works 0-based.
"""

from __future__ import annotations

import dataclasses
import gzip
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Energy grid of the shipped 5-125 keV tables.
DEFAULT_E0_EV = 5000.0
DEFAULT_DE_EV = 5.0
DEFAULT_N_BINS = 24001


@dataclasses.dataclass(frozen=True)
class Material:
    """Registry entry for a single material."""

    identifier: str
    name: str
    chemical_formula: str
    density: float  # nominal density [g/cm^3]
    number: int  # 1-based material number used in geometry arrays

    @property
    def index(self) -> int:
        """0-based index into the packed tables."""
        return self.number - 1


@dataclasses.dataclass
class MaterialTables:
    """Raw tables of one material (numpy, host-side)."""

    identifier: str
    name: str
    chemical_formula: str
    density: float
    e0: float
    de: float
    # [n_bins] mean free paths in cm at nominal density
    mfp_rayleigh: np.ndarray
    mfp_compton: np.ndarray
    mfp_photoelectric: np.ndarray
    mfp_total: np.ndarray
    # [n_bins] maximum cumulative probability of the squared form factor
    rayleigh_pmax: np.ndarray
    # RITA tables [NP_RAYLEIGH]
    rita_x: np.ndarray
    rita_p: np.ndarray
    rita_a: np.ndarray
    rita_b: np.ndarray
    rita_itl: np.ndarray  # int, 1-based interval lower limits
    rita_itu: np.ndarray  # int, 1-based interval upper limits
    # Compton shells [n_shells]
    shell_f: np.ndarray  # occupation number
    shell_ui: np.ndarray  # ionisation energy [eV]
    shell_j0: np.ndarray  # Hartree-Fock profile parameter

    @property
    def n_bins(self) -> int:
        return len(self.mfp_total)

    @property
    def n_shells(self) -> int:
        return len(self.shell_f)


def parse_mcgpu_material_file(filepath: Path | str) -> MaterialTables:
    """Parse a ``.mcgpu`` material interchange file (optionally gzipped).

    Format (see reference assets/material_files/*.mcgpu): a commented header
    with material name and nominal density, N rows of
    ``E rayleighMFP comptonMFP photoMFP totalMFP pmax``, a 128-row RITA
    block and a Compton shell block.
    """
    filepath = Path(filepath)
    opener = gzip.open if filepath.suffix == ".gz" else open
    with opener(filepath, "rt") as f:
        lines = f.read().splitlines()

    name = None
    density = None
    n_values = None
    i = 0
    data_start = None
    while i < len(lines):
        line = lines[i]
        if "[MATERIAL NAME]" in line:
            name = lines[i + 1].lstrip("# ").strip()
        elif "[NOMINAL DENSITY" in line:
            density = float(lines[i + 1].lstrip("# ").strip())
        elif "[NUMBER OF DATA VALUES]" in line:
            n_values = int(lines[i + 1].lstrip("# ").strip())
        elif "[MEAN FREE PATHS" in line:
            # one more comment line (column header) follows
            data_start = i + 2
            break
        i += 1
    if None in (name, density, n_values, data_start):
        raise ValueError(f"Malformed material file header: {filepath}")

    mfp_rows = np.loadtxt(lines[data_start : data_start + n_values], dtype=np.float64)
    if mfp_rows.shape != (n_values, 6):
        raise ValueError(f"Expected {n_values}x6 MFP block in {filepath}")

    energies = mfp_rows[:, 0]
    e0 = float(energies[0])
    de = float(energies[1] - energies[0])
    if not np.allclose(np.diff(energies), de, rtol=1e-3):
        raise ValueError(f"Non-uniform energy grid in {filepath}")

    # RITA block
    i = data_start + n_values
    while "[DATA VALUES" not in lines[i]:
        i += 1
    n_rita = int(lines[i + 1].lstrip("# ").strip())
    rita_rows = np.loadtxt(lines[i + 3 : i + 3 + n_rita], dtype=np.float64)
    if rita_rows.shape != (n_rita, 6):
        raise ValueError(f"Expected {n_rita}x6 RITA block in {filepath}")

    # Compton shells
    i = i + 3 + n_rita
    while "[NUMBER OF SHELLS" not in lines[i]:
        i += 1
    n_shells = int(lines[i + 1].lstrip("# ").strip())
    shell_rows = np.loadtxt(
        lines[i + 3 : i + 3 + n_shells], dtype=np.float64, ndmin=2
    )

    if match := re.match(r"(?P<name>.+)\((?P<formula>.*)\)", name):
        mat_name = match.group("name")
        formula = match.group("formula")
    else:
        mat_name, formula = name, ""

    identifier = str(filepath.name).split("__")[0]

    return MaterialTables(
        identifier=identifier,
        name=mat_name,
        chemical_formula=formula,
        density=density,
        e0=e0,
        de=de,
        mfp_rayleigh=mfp_rows[:, 1].astype(np.float32),
        mfp_compton=mfp_rows[:, 2].astype(np.float32),
        mfp_photoelectric=mfp_rows[:, 3].astype(np.float32),
        mfp_total=mfp_rows[:, 4].astype(np.float32),
        rayleigh_pmax=mfp_rows[:, 5].astype(np.float32),
        rita_x=rita_rows[:, 0].astype(np.float32),
        rita_p=rita_rows[:, 1].astype(np.float32),
        rita_a=rita_rows[:, 2].astype(np.float32),
        rita_b=rita_rows[:, 3].astype(np.float32),
        rita_itl=rita_rows[:, 4].astype(np.int32),
        rita_itu=rita_rows[:, 5].astype(np.int32),
        shell_f=shell_rows[:, 0].astype(np.float32),
        shell_ui=shell_rows[:, 1].astype(np.float32),
        shell_j0=shell_rows[:, 2].astype(np.float32),
    )


@dataclasses.dataclass
class MaterialTableSet:
    """A full set of materials, ordered by nominal density (= material number
    order)."""

    materials: List[MaterialTables]

    def __post_init__(self):
        self._by_id = {m.identifier: i for i, m in enumerate(self.materials)}

    @property
    def n_materials(self) -> int:
        return len(self.materials)

    @property
    def identifiers(self) -> List[str]:
        return [m.identifier for m in self.materials]

    @property
    def densities(self) -> np.ndarray:
        return np.array([m.density for m in self.materials], dtype=np.float32)

    @property
    def e0(self) -> float:
        return self.materials[0].e0

    @property
    def de(self) -> float:
        return self.materials[0].de

    @property
    def n_bins(self) -> int:
        return self.materials[0].n_bins

    def index_of(self, identifier: str) -> int:
        return self._by_id[identifier]

    def material(self, identifier: str) -> Material:
        i = self.index_of(identifier)
        m = self.materials[i]
        return Material(
            identifier=m.identifier,
            name=m.name,
            chemical_formula=m.chemical_formula,
            density=m.density,
            number=i + 1,
        )

    @property
    def registry(self) -> Dict[str, Material]:
        return {m.identifier: self.material(m.identifier) for m in self.materials}

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_mcgpu_files(cls, filepaths: Sequence[Path | str]) -> "MaterialTableSet":
        materials = [parse_mcgpu_material_file(p) for p in filepaths]
        # sort by density: defines material numbers (parity with reference)
        materials.sort(key=lambda m: m.density)
        e0s = {m.e0 for m in materials}
        n_bins = {m.n_bins for m in materials}
        if len(e0s) != 1 or len(n_bins) != 1:
            raise ValueError("All materials must share one energy grid")
        return cls(materials=materials)

    @classmethod
    def from_directory(cls, directory: Path | str, pattern: str = "*.mcgpu"):
        filepaths = sorted(Path(directory).glob(pattern))
        if not filepaths:
            raise FileNotFoundError(f"No material files in {directory}")
        return cls.from_mcgpu_files(filepaths)

    # ------------------------------------------------------------------
    # packed npz asset
    # ------------------------------------------------------------------
    def save_npz(self, filepath: Path | str):
        max_shells = max(m.n_shells for m in self.materials)
        n_mats = self.n_materials
        n_bins = self.n_bins

        def stack(attr):
            return np.stack([getattr(m, attr) for m in self.materials])

        shell_f = np.zeros((n_mats, max_shells), np.float32)
        shell_ui = np.full((n_mats, max_shells), np.float32(np.inf))
        shell_j0 = np.full((n_mats, max_shells), np.float32(1.0))
        n_shells = np.zeros((n_mats,), np.int32)
        for i, m in enumerate(self.materials):
            n_shells[i] = m.n_shells
            shell_f[i, : m.n_shells] = m.shell_f
            shell_ui[i, : m.n_shells] = m.shell_ui
            shell_j0[i, : m.n_shells] = m.shell_j0

        np.savez_compressed(
            filepath,
            identifiers=np.array(self.identifiers),
            names=np.array([m.name for m in self.materials]),
            formulas=np.array([m.chemical_formula for m in self.materials]),
            densities=self.densities,
            e0=np.float64(self.e0),
            de=np.float64(self.de),
            mfp_rayleigh=stack("mfp_rayleigh"),
            mfp_compton=stack("mfp_compton"),
            mfp_photoelectric=stack("mfp_photoelectric"),
            mfp_total=stack("mfp_total"),
            rayleigh_pmax=stack("rayleigh_pmax"),
            rita_x=stack("rita_x"),
            rita_p=stack("rita_p"),
            rita_a=stack("rita_a"),
            rita_b=stack("rita_b"),
            rita_itl=stack("rita_itl"),
            rita_itu=stack("rita_itu"),
            n_shells=n_shells,
            shell_f=shell_f,
            shell_ui=shell_ui,
            shell_j0=shell_j0,
        )

    @classmethod
    def from_npz(cls, filepath: Path | str) -> "MaterialTableSet":
        data = np.load(filepath, allow_pickle=False)
        n_mats = len(data["identifiers"])
        materials = []
        for i in range(n_mats):
            ns = int(data["n_shells"][i])
            materials.append(
                MaterialTables(
                    identifier=str(data["identifiers"][i]),
                    name=str(data["names"][i]),
                    chemical_formula=str(data["formulas"][i]),
                    density=float(data["densities"][i]),
                    e0=float(data["e0"]),
                    de=float(data["de"]),
                    mfp_rayleigh=data["mfp_rayleigh"][i],
                    mfp_compton=data["mfp_compton"][i],
                    mfp_photoelectric=data["mfp_photoelectric"][i],
                    mfp_total=data["mfp_total"][i],
                    rayleigh_pmax=data["rayleigh_pmax"][i],
                    rita_x=data["rita_x"][i],
                    rita_p=data["rita_p"][i],
                    rita_a=data["rita_a"][i],
                    rita_b=data["rita_b"][i],
                    rita_itl=data["rita_itl"][i],
                    rita_itu=data["rita_itu"][i],
                    shell_f=data["shell_f"][i][:ns],
                    shell_ui=data["shell_ui"][i][:ns],
                    shell_j0=data["shell_j0"][i][:ns],
                )
            )
        return cls(materials=materials)


_DEFAULT_ASSET = Path(__file__).parent.parent / "assets" / "materials_125kev.npz"
_default_set_cache: MaterialTableSet | None = None


def default_material_set() -> MaterialTableSet:
    """The bundled 22-material 5-125 keV table set."""
    global _default_set_cache
    if _default_set_cache is None:
        _default_set_cache = MaterialTableSet.from_npz(_DEFAULT_ASSET)
    return _default_set_cache


def linearize_inverse_mfp(
    mfp: np.ndarray, density: np.ndarray, e0: float, de: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Linear-interpolation coefficients (a, b) of the inverse MFP scaled by
    nominal density: ``inv_mfp(E) = a[bin] + E * b[bin]`` with
    ``bin = floor((E - e0) / de)``; the slope of the last bin repeats the
    second-to-last.

    Args:
        mfp: [n_mats, n_bins] mean free paths [cm] at nominal density.
        density: [n_mats] nominal densities [g/cm^3].
    Returns:
        (a, b) each [n_mats, n_bins], float32.
    """
    inv = 1.0 / (mfp.astype(np.float64) * density[:, None].astype(np.float64))
    b = np.empty_like(inv)
    b[:, :-1] = (inv[:, 1:] - inv[:, :-1]) / de
    b[:, -1] = b[:, -2]
    energies = e0 + de * np.arange(inv.shape[1], dtype=np.float64)
    a = inv - energies[None, :] * b
    return a.astype(np.float32), b.astype(np.float32)


def build_woodcock_coefficients(
    table_set: MaterialTableSet, max_density: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Woodcock (majorant) MFP linear-interpolation table for one voxel
    geometry: per energy bin the minimum total MFP over the materials
    present, each rescaled to the maximum density it reaches in the voxels.

    Args:
        max_density: [n_mats] maximum voxel density per material; entries
            <= 0 mark materials not present (ignored).
    Returns:
        (a, b) each [n_bins] float32 with ``mfp_wc(E) = a[bin] + E*b[bin]``.
    """
    max_density = np.asarray(max_density, dtype=np.float64)
    if max_density.shape != (table_set.n_materials,):
        raise ValueError("max_density must have one entry per material")
    present = max_density > 0.0
    if not present.any():
        raise ValueError("No materials present in geometry")

    mfp_total = np.stack([m.mfp_total for m in table_set.materials]).astype(np.float64)
    densities = table_set.densities.astype(np.float64)
    scaled = np.where(
        present[:, None],
        mfp_total * (densities / np.where(present, max_density, 1.0))[:, None],
        np.inf,
    )
    mfp_wc = scaled.min(axis=0)

    de = table_set.de
    b = np.empty_like(mfp_wc)
    b[:-1] = (mfp_wc[1:] - mfp_wc[:-1]) / de
    b[-1] = b[-2]
    energies = table_set.e0 + de * np.arange(len(mfp_wc))
    a = mfp_wc - energies * b
    return a.astype(np.float32), b.astype(np.float32)
