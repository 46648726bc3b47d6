"""HEP coherent unit system (CLHEP conventions).

Base units: millimeter, nanosecond, MeV, positron charge (e), kelvin.
Mirrors the unit surface consumed by the reference simulator
(larnd-sim consts/units.py) so that property YAML files and
stored HDF5 attributes are interpreted identically.  Only the symbols the
simulator actually uses are defined here.  A copy of ``larndsim_tpu.units``,
so that the port runs without the JAX package.
"""

# Length
millimeter = 1.0
centimeter = 10.0 * millimeter
meter = 1000.0 * millimeter
mm = millimeter
cm = centimeter
m = meter

# Time
nanosecond = 1.0
second = 1.0e9 * nanosecond
microsecond = 1.0e-6 * second
millisecond = 1.0e-3 * second
ns = nanosecond
s = second
mus = microsecond
ms = millisecond

# Charge
e = 1.0  # positron charge
e_SI = -1.60217733e-19  # electron charge in coulomb
coulomb = e / e_SI

# Energy
megaelectronvolt = 1.0
electronvolt = 1.0e-6 * megaelectronvolt
kiloelectronvolt = 1.0e-3 * megaelectronvolt
gigaelectronvolt = 1.0e3 * megaelectronvolt
eV = electronvolt
keV = kiloelectronvolt
MeV = megaelectronvolt
GeV = gigaelectronvolt

# Electric potential: [E]/[Q]
megavolt = megaelectronvolt / e
kilovolt = 1.0e-3 * megavolt
volt = 1.0e-6 * megavolt
millivolt = 1.0e-3 * volt
V = volt
mV = millivolt
kV = kilovolt
MV = megavolt

# Temperature
kelvin = 1.0
K = kelvin
