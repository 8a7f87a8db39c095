"""Host-side elliptic-curve layer: curves, points, isogenies, chains.

Capability parity with /root/reference/src/ec.rs, re-designed around plain
python-int field arithmetic (construction is host-side and runs once per
(field, size); only the resulting leaf domains / rational maps ship to the
device). Covers:

- general Weierstrass group law (ec.rs:363-489)
- ShortWeierstrassCurve + Vélu 2-isogenies (ec.rs:204-264)
- GoodCurve (ECFFT-II) + closed-form good isogenies (ec.rs:28-90)
- two_adicity (utils.rs:356-365), find_isogeny_chain (ec.rs:177-189)
- leaf-domain generation for FFTree construction (ec.rs:498-554, lib.rs:67-79)
"""

from __future__ import annotations

from dataclasses import dataclass

from ecfft_tpu.fields.host import inv_mod, sqrt_mod
from ecfft_tpu.utils.poly import evaluate, find_roots


@dataclass(frozen=True)
class RationalMap:
    """num(x) / den(x), coefficients low-degree-first
    (/root/reference/src/utils.rs:367-390)."""

    numerator: tuple
    denominator: tuple
    p: int

    def __call__(self, x: int) -> int | None:
        den = evaluate(list(self.denominator), x, self.p)
        if den == 0:
            return None
        num = evaluate(list(self.numerator), x, self.p)
        return num * inv_mod(den, self.p) % self.p

    @staticmethod
    def zero(p: int) -> "RationalMap":
        return RationalMap((), (1,), p)


class Curve:
    """General Weierstrass curve y² + a1·xy + a3·y = x³ + a2·x² + a4·x + a6
    (/root/reference/src/ec.rs:291-312). Subclasses provide a1..a6 and p."""

    p: int

    def a1(self) -> int:
        return 0

    def a2(self) -> int:
        return 0

    def a3(self) -> int:
        return 0

    def a4(self) -> int:
        return 0

    def a6(self) -> int:
        return 0

    def contains(self, x: int, y: int) -> bool:
        p = self.p
        lhs = (y * y + self.a1() * x * y + self.a3() * y) % p
        rhs = (x * x * x + self.a2() * x * x + self.a4() * x + self.a6()) % p
        return lhs == rhs


@dataclass(frozen=True)
class ShortWeierstrass(Curve):
    """y² = x³ + a·x + b (/root/reference/src/ec.rs:204-207)."""

    a: int
    b: int
    p: int

    def a4(self) -> int:
        return self.a

    def a6(self) -> int:
        return self.b

    def x3_ax_b(self) -> list[int]:
        """The polynomial x³ + a·x + b (/root/reference/src/ec.rs:262-264)."""
        return [self.b % self.p, self.a % self.p, 0, 1]

    def two_torsion_points(self) -> list["Point"]:
        """Non-zero order-2 points: roots of x³+ax+b
        (/root/reference/src/ec.rs:245-259)."""
        return [Point(r, 0, self) for r in find_roots(self.x3_ax_b(), self.p)]

    def two_isogenies(self) -> list["Isogeny"]:
        """All 2-isogenies via Vélu's formulas
        (/root/reference/src/ec.rs:214-242)."""
        p = self.p
        out = []
        for pt in self.two_torsion_points():
            x0 = pt.x
            t = (3 * x0 * x0 + self.a) % p
            codomain = ShortWeierstrass(
                (self.a - 5 * t) % p, (self.b - 7 * x0 * t) % p, p
            )
            r = RationalMap((t % p, (-x0) % p, 1), ((-x0) % p, 1), p)
            g = RationalMap.zero(p)
            h = RationalMap(
                ((x0 * x0 - t) % p, (-2 * x0) % p, 1),
                ((x0 * x0) % p, (-2 * x0) % p, 1),
                p,
            )
            out.append(Isogeny(self, codomain, r, g, h))
        return out


@dataclass(frozen=True)
class GoodCurve(Curve):
    """ECFFT-II good curve, odd characteristic:
    y² = x³ + a·x² + B·x with B = b² (/root/reference/src/ec.rs:28-35).

    ``b`` is a square root of ``bb``; constructors validate non-singularity
    and the residuosity conditions (ec.rs:38-45). Even-characteristic good
    curves are out of scope (the reference's even-char find_curve is
    unfinished, find_curve.rs:244).
    """

    a: int
    b: int
    p: int
    bb_override: int | None = None  # degenerate form: B given directly

    @staticmethod
    def new_odd(a: int, bb: int, p: int) -> "GoodCurve":
        from ecfft_tpu.errors import CurveError

        a %= p
        bb %= p
        if bb == 0 or (a * a - 4 * bb) % p == 0:
            raise CurveError("singular curve (ec.rs:41-42)")
        b = sqrt_mod(bb, p)
        if b is None:
            raise CurveError("B must be a quadratic residue (ec.rs:43)")
        # the good-curve condition fixes the SIGN of b: pick the root
        # with a + 2b a quadratic residue (when the 2-Sylow is cyclic
        # exactly one of a ± 2b is — their product is the non-residue
        # discriminant)
        if sqrt_mod((a + 2 * b) % p, p) is None:
            b = (-b) % p
        if sqrt_mod((a + 2 * b) % p, p) is None:
            raise CurveError(
                "neither sign of sqrt(B) makes a + 2b a quadratic residue"
            )
        return GoodCurve(a, b, p)

    def a2(self) -> int:
        return self.a

    def a4(self) -> int:
        if self.bb_override is not None:
            return self.bb_override
        return self.b * self.b % self.p

    def good_point(self) -> "Point":
        """The distinguished point (a, b²) (/root/reference/src/ec.rs:54-59)."""
        return Point(self.a % self.p, self.b * self.b % self.p, self)

    def good_isogeny(self) -> "Isogeny":
        """Closed-form 2-isogeny to the next good curve
        (/root/reference/src/ec.rs:75-88):
        codomain (a' = a+6b, B' = 4ab+8b²), x-map r = (x²−2bx+b²)/x,
        y-map h = (x²−b²)/x².

        When B' is a non-residue (possible at the tail of a chain, where
        no rational 4-torsion remains above the kernel) the codomain
        cannot be written in good form; a degenerate GoodCurve carrying
        B' directly is returned — its group law is still exact, only a
        further good_isogeny from it is impossible.
        """
        p = self.p
        a, b = self.a, self.b
        bb = b * b % p
        a_prime = (a + 6 * b) % p
        b_prime = (4 * a * b + 8 * bb) % p
        from ecfft_tpu.errors import CurveError

        try:
            codomain = GoodCurve.new_odd(a_prime, b_prime, p)
        except CurveError:
            codomain = GoodCurve(a_prime, 0, p, bb_override=b_prime)
        r = RationalMap((bb, (-2 * b) % p, 1), (0, 1), p)
        g = RationalMap.zero(p)
        h = RationalMap(((-bb) % p, 0, 1), (0, 0, 1), p)
        return Isogeny(self, codomain, r, g, h)


@dataclass(frozen=True)
class Isogeny:
    """φ(x, y) = (r(x), g(x) + h(x)·y) (/root/reference/src/ec.rs:314-359)."""

    domain: Curve
    codomain: Curve
    r: RationalMap
    g: RationalMap
    h: RationalMap

    def map(self, pt: "Point") -> "Point":
        if pt.is_zero():
            return Point.zero()
        assert pt.curve == self.domain
        rx = self.r(pt.x)
        gx = self.g(pt.x)
        hx = self.h(pt.x)
        if rx is None or gx is None or hx is None:
            return Point.zero()
        p = self.domain.p
        return Point(rx, (gx + hx * pt.y) % p, self.codomain)


class Point:
    """Affine point; ``curve is None`` means the point at infinity
    (/root/reference/src/ec.rs:363-374,477-489)."""

    __slots__ = ("x", "y", "curve")

    def __init__(self, x: int, y: int, curve: Curve | None):
        self.x = x % curve.p if curve is not None else 0
        self.y = y % curve.p if curve is not None else 0
        self.curve = curve

    @staticmethod
    def zero() -> "Point":
        return Point(0, 0, None)

    def is_zero(self) -> bool:
        return self.curve is None

    def __eq__(self, other) -> bool:
        if self.is_zero() and other.is_zero():
            return True
        if self.is_zero() or other.is_zero():
            return False
        assert self.curve == other.curve
        return self.x == other.x and self.y == other.y

    def __neg__(self) -> "Point":
        """Silverman III.2.3 (/root/reference/src/ec.rs:449-464)."""
        if self.is_zero():
            return self
        c = self.curve
        return Point(self.x, (-self.y - c.a1() * self.x - c.a3()) % c.p, c)

    def __add__(self, rhs: "Point") -> "Point":
        """Full Weierstrass addition incl. tangent case, Silverman III.2.3
        (/root/reference/src/ec.rs:376-424)."""
        if self.is_zero():
            return rhs
        if rhs.is_zero():
            return self
        if self.curve != rhs.curve:
            raise ValueError("points belong to different curves")
        c = self.curve
        p = c.p
        a1, a2, a3, a4, a6 = c.a1(), c.a2(), c.a3(), c.a4(), c.a6()
        x1, y1, x2, y2 = self.x, self.y, rhs.x, rhs.y
        if x1 == x2 and (y1 + y2 + a1 * x2 + a3) % p == 0:
            return Point.zero()
        if x1 == x2:
            # tangent line
            den = inv_mod(2 * y1 + a1 * x1 + a3, p)
            lam = (3 * x1 * x1 + 2 * a2 * x1 + a4 - a1 * y1) * den % p
            nu = (-(x1 * x1 * x1) + a4 * x1 + 2 * a6 - a3 * y1) * den % p
        else:
            den = inv_mod(x2 - x1, p)
            lam = (y2 - y1) * den % p
            nu = (y1 * x2 - y2 * x1) * den % p
        x3 = (lam * lam + a1 * lam - a2 - x1 - x2) % p
        y3 = (-(lam + a1) * x3 - nu - a3) % p
        return Point(x3, y3, c)

    def double(self) -> "Point":
        return self + self

    def __mul__(self, k: int) -> "Point":
        """Double-and-add (/root/reference/src/ec.rs:432-447)."""
        res = Point.zero()
        acc = self
        while k:
            if k & 1:
                res = res + acc
            acc = acc + acc
            k >>= 1
        return res

    def __repr__(self) -> str:
        if self.is_zero():
            return "Point(∞)"
        return f"Point({self.x}, {self.y})"


def two_adicity(pt: Point, cap: int = 2048) -> int | None:
    """k with 2^k·P = 0, or None if P isn't of 2-power order
    (/root/reference/src/utils.rs:356-365)."""
    acc = pt
    for i in range(cap):
        if acc.is_zero():
            return i
        acc = acc.double()
    return None


def find_isogeny_chain(generator: Point) -> list[Isogeny]:
    """Chain of k good isogenies for a GoodCurve generator of order 2^k
    (/root/reference/src/ec.rs:177-189).

    The reference takes the curve's convention ``b`` (new_odd's sqrt sign)
    at every step and asserts the generator's 2-adicity drops by exactly
    one (ec.rs:184). Quotient curves generically acquire full rational
    2-torsion, so on some discovered curves (surfaced over 2^255−19) the
    convention sign yields a codomain whose B' is a non-residue and the
    chain stalls — the reference would panic there. We therefore prefer
    the reference's convention label (keeping chains byte-identical to
    reference-built trees on the hardcoded fields), and fall back to
    relabeling ``b`` to x(P₄) for P₄ = 2^(k−2)·g — the same curve, since
    x(P₄)² = B — only when the convention step would stall. The x(P₄)
    label always works: it guarantees the kernel {O, (0,0)} = ⟨2^(k−1)·g⟩
    and a square B' = (2·x(P₄'))².
    """
    from ecfft_tpu.errors import CurveError

    k = two_adicity(generator)
    if k is None:
        raise CurveError("generator is not a point of order 2^k")
    chain = []
    g = generator
    for i in range(k):
        k_cur = k - i
        candidates = [g]
        if k_cur >= 2:
            p4 = g * (1 << (k_cur - 2))
            if g.curve.b != p4.x:
                relabeled = GoodCurve(g.curve.a, p4.x, g.curve.p)
                candidates.append(Point(g.x, g.y, relabeled))
        chosen = None
        for cand in candidates:
            if cand.curve.bb_override is not None:
                continue  # degenerate label can't take a good isogeny
            iso = cand.curve.good_isogeny()
            g_prime = iso.map(cand)
            if two_adicity(cand) == two_adicity(g_prime) + 1:
                chosen = (iso, g_prime)
                break
        if chosen is None:
            raise CurveError(
                "good isogeny failed to halve the generator's order"
            )
        chain.append(chosen[0])
        g = chosen[1]
    return chain


def find_isogeny_chain_velu(generator: Point, log_n: int) -> list[Isogeny]:
    """Search-based chain for generic ShortWeierstrass curves: at each of
    log_n levels pick the Vélu 2-isogeny that drops the generator's
    two-adicity by exactly 1 (/root/reference/src/ec.rs:523-543)."""
    chain = []
    g = generator
    for _ in range(log_n):
        found = None
        for iso in g.curve.two_isogenies():
            g_prime = iso.map(g)
            ta, tb = two_adicity(g), two_adicity(g_prime)
            if ta is not None and tb is not None and ta == tb + 1:
                found = (iso, g_prime)
                break
        if found is None:
            from ecfft_tpu.errors import CurveError

            raise CurveError(
                "cannot find a two-adicity-reducing isogeny (ec.rs:541)"
            )
        chain.append(found[0])
        g = found[1]
    return chain


def coset_leaves(coset_offset: Point, generator: Point, n: int) -> list[int]:
    """x-coords of coset_offset + i·generator for i in 0..n
    (/root/reference/src/lib.rs:72-79, src/ec.rs:545-551)."""
    leaves = []
    acc = Point.zero()
    for _ in range(n):
        leaves.append((coset_offset + acc).x)
        acc = acc + generator
    return leaves
