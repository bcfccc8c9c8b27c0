# frozen copy of nuradiomc_tpu_torch/utils/units.py (commit 493e4d9), cut to what the benchmark's reference calls; imports rewritten to portbench.reference
# copied from nuradiomc_tpu/utils/units.py:1-205 (the port keeps its own copy; it imports nothing of the JAX package)
"""Standard system of units.

Multiply-in / divide-out unit constants. The internal unit system uses the
same base units as the reference framework (NuRadioReco/utilities/units.py:30-49):

* length .......... meter
* time ............ nanosecond
* energy .......... electron volt
* charge .......... positron charge
* temperature ..... kelvin
* angle ........... radian

Usage::

    d = 1.5 * units.km          # store
    print(d / units.mm, "mm")  # read out

Every dimensional constant in this package is expressed in this system, so all
device arrays carry consistent, dimensionless float values.
"""

# -- metric prefixes ---------------------------------------------------------
yocto = 1e-24
zepto = 1e-21
atto = 1e-18
femto = 1e-15
pico = 1e-12
nano = 1e-9
micro = 1e-6
milli = 1e-3
centi = 1e-2
deci = 1e-1
deka = 1e1
hecto = 1e2
kilo = 1e3
mega = 1e6
giga = 1e9
tera = 1e12
peta = 1e15
exa = 1e18
zetta = 1e21
yotta = 1e24

# -- length [L] --------------------------------------------------------------
meter = 1.0
meter2 = meter ** 2
meter3 = meter ** 3
millimeter = milli * meter
centimeter = centi * meter
kilometer = kilo * meter
micrometer = micro * meter
nanometer = nano * meter
fermi = femto * meter
feet = 0.3048 * meter
parsec = 3.0856775807e16 * meter

barn = 1e-28 * meter2
millibarn = milli * barn
microbarn = micro * barn
nanobarn = nano * barn
picobarn = pico * barn

mm = millimeter
mm2 = mm ** 2
mm3 = mm ** 3
cm = centimeter
cm2 = cm ** 2
cm3 = cm ** 3
m = meter
m2 = meter2
m3 = meter3
km = kilometer
km2 = km ** 2
km3 = km ** 3

# -- angle -------------------------------------------------------------------
radian = 1.0
milliradian = milli * radian
degree = 3.14159265358979323846 / 180.0 * radian
steradian = 1.0
rad = radian
mrad = milliradian
sr = steradian
deg = degree

# -- time [T] ----------------------------------------------------------------
nanosecond = 1.0
second = giga * nanosecond
millisecond = milli * second
microsecond = micro * second
picosecond = pico * second
femtosecond = femto * second
minute = 60 * second
hour = 60 * minute
day = 24 * hour
year = 365.25 * day

h = hour
s = second
ms = millisecond
mus = microsecond
ns = nanosecond
ps = picosecond
fs = femtosecond

# -- frequency [T^-1] --------------------------------------------------------
hertz = 1.0 / second
kilohertz = kilo * hertz
megahertz = mega * hertz
gigahertz = giga * hertz
mHz = milli * hertz
Hz = hertz
kHz = kilohertz
MHz = megahertz
GHz = gigahertz

# -- electric charge [Q] -----------------------------------------------------
eplus = 1.0
eSI = 1.602176462e-19  # positron charge in coulomb
coulomb = eplus / eSI

# -- energy [E] --------------------------------------------------------------
electronvolt = 1.0
kiloelectronvolt = kilo * electronvolt
megaelectronvolt = mega * electronvolt
gigaelectronvolt = giga * electronvolt
teraelectronvolt = tera * electronvolt
petaelectronvolt = peta * electronvolt
exaelectronvolt = exa * electronvolt
zettaelectronvolt = zetta * electronvolt
joule = electronvolt / eSI
erg = 1e-7 * joule

eV = electronvolt
keV = kiloelectronvolt
MeV = megaelectronvolt
GeV = gigaelectronvolt
TeV = teraelectronvolt
PeV = petaelectronvolt
EeV = exaelectronvolt
ZeV = zettaelectronvolt
J = joule

# -- mass [E T^2 L^-2] -------------------------------------------------------
kilogram = joule * second * second / (meter * meter)
gram = milli * kilogram
milligram = milli * gram
kg = kilogram
g = gram
mg = milligram

# -- power / force / pressure ------------------------------------------------
watt = joule / second
newton = joule / meter
pascal = newton / m2
bar = 100000 * pascal
atmosphere = 101325 * pascal
hPa = hecto * pascal

# -- electric ----------------------------------------------------------------
ampere = coulomb / second
milliampere = milli * ampere
microampere = micro * ampere
nanoampere = nano * ampere

volt = electronvolt / eplus
microvolt = micro * volt
millivolt = milli * volt
kilovolt = kilo * volt
megavolt = mega * volt
V = volt
mV = millivolt
muV = microvolt

ohm = volt / ampere
farad = coulomb / volt
millifarad = milli * farad
microfarad = micro * farad
nanofarad = nano * farad
picofarad = pico * farad
weber = volt * second
tesla = volt * second / meter2
microtesla = micro * tesla
gauss = 1e-4 * tesla
kilogauss = deci * tesla
henry = weber / ampere

# -- misc --------------------------------------------------------------------
kelvin = 1.0
K = kelvin
mole = 1.0
becquerel = 1.0 / second
curie = 3.7e10 * becquerel
gray = joule / kilogram
candela = 1.0
lumen = candela * steradian
lux = lumen / meter2
jansky = 1e-26 * watt / m2 / Hz

fraction = 1.0
perCent = 0.01
percent = perCent
perThousand = 0.001
permil = perThousand
perMillion = 1e-6
